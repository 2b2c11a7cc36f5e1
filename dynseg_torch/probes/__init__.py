"""Measurement entry points of the port (counterparts of scripts/*_probe.py)."""

import os
import sys


def import_from(root: str) -> str:
    """Import the dynseg_torch package found in `root` in place of any
    already imported from elsewhere, so that a probe's `--root DIR` runs
    another checkout's package (a `git archive` of an earlier commit, say)
    in the same process. Returns the package's directory's parent, which
    is `root`; exits if the package came from anywhere else."""
    root = os.path.abspath(root)
    for name in [m for m in sys.modules if m.split(".")[0] == "dynseg_torch"]:
        del sys.modules[name]
    sys.path.insert(0, root)
    import dynseg_torch

    pkg = os.path.dirname(os.path.dirname(os.path.abspath(dynseg_torch.__file__)))
    if pkg != root:
        raise SystemExit(f"--root {root}: dynseg_torch was imported from {pkg}")
    return pkg
