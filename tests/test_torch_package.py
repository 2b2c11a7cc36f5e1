"""dynseg_torch stands alone on a machine without JAX and without the JAX
package, and its kernel wrappers never quietly fall back to the plain
versions."""

import os
import re
import subprocess
import sys

import pytest
import torch

from dynseg_torch.ops import gather, int8_conv, pool

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# A subprocess prelude that makes the JAX package and JAX itself absent:
# a meta-path finder refuses their top-level names, as an interpreter
# without them would.
ABSENT = "\n".join([
    "import importlib.abc, sys",
    "class Absent(importlib.abc.MetaPathFinder):",
    "    def find_spec(self, name, path=None, target=None):",
    "        if name.split('.')[0] in ('dynseg', 'jax', 'flax', 'optax'):",
    "            raise ModuleNotFoundError(f'No module named {name!r}', name=name)",
    "        return None",
    "sys.meta_path.insert(0, Absent())",
])


def test_every_module_imports_without_the_jax_package():
    """Every module of dynseg_torch imports, and the command line runs
    check_data and --help, where dynseg, jax, flax and optax are absent."""
    code = "\n".join([
        ABSENT,
        "import contextlib, io, pkgutil",
        "import dynseg_torch",
        "names = [m.name for m in pkgutil.walk_packages(dynseg_torch.__path__, 'dynseg_torch.')",
        "         if not m.name.endswith('__main__')]",
        "assert len(names) >= 50, names",
        "assert {'dynseg_torch.export', 'dynseg_torch.serve', 'dynseg_torch.parallel',",
        "        'dynseg_torch.utils.profiling', 'dynseg_torch.probes.dp_parity',",
        "        'dynseg_torch.probes.stress_scale', 'dynseg_torch.probes.profile_multitile',",
        "        'dynseg_torch.probes.sweep_dense', 'dynseg_torch.probes.study',",
        "        'dynseg_torch.probes.sched_ablation', 'dynseg_torch.probes.mode_gap',",
        "        'dynseg_torch.probes.bf16_eval', 'dynseg_torch.probes.parity_bracket',",
        "        'dynseg_torch.probes.diagnose_collapse',",
        "        'dynseg_torch.probes.ema_recalib_probe'} <= set(names), names",
        "for name in names:",
        "    __import__(name)",
        "from dynseg_torch.cli import main",
        "rc = main(['--operation', 'check_data', '--dataset', 'synthetic',",
        "           '--dataset_kwargs', '{\"size\": 32}', '--values', '9'])",
        "assert rc == 0, rc",
        "out = io.StringIO()",
        "with contextlib.redirect_stdout(out), contextlib.suppress(SystemExit):",
        "    main(['--help'])",
        "assert '--device' in out.getvalue()",
        "bad = sorted(m for m in sys.modules",
        "             if m.split('.')[0] in ('dynseg', 'jax', 'flax', 'optax'))",
        "assert not bad, bad",
    ])
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300, cwd=ROOT)


def test_the_finder_makes_the_jax_package_absent():
    """The prelude of the test above does refuse the JAX package."""
    code = ABSENT + "\nimport dynseg.config\n"
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert res.returncode != 0 and "No module named 'dynseg'" in res.stderr


def test_no_source_line_imports_the_jax_package():
    """No file of dynseg_torch has an import of dynseg, jax, flax or
    optax."""
    pattern = re.compile(r"^\s*(import|from)\s+(dynseg|jax|flax|optax)(\.|\s|$)")
    files = []
    for base, _, names in os.walk(os.path.join(ROOT, "dynseg_torch")):
        files += [os.path.join(base, n) for n in names if n.endswith(".py")]
    assert len(files) >= 28
    bad = []
    for path in files:
        with open(path) as f:
            bad += [f"{path}:{i}: {line.strip()}" for i, line in enumerate(f, 1)
                    if pattern.match(line)]
    assert not bad, bad


def test_package_imports_no_jax():
    code = ("import sys, dynseg_torch, dynseg_torch.infer, dynseg_torch.ops.quant, "
            "dynseg_torch.bridge, dynseg_torch.train, dynseg_torch.cli, "
            "dynseg_torch.ops.gather, dynseg_torch.ops.pool, dynseg_torch.checkpoint, "
            "dynseg_torch.ops.int8_probe_conv, dynseg_torch.probes.int8_kernel_probe, "
            "dynseg_torch.export, dynseg_torch.serve, dynseg_torch.parallel, "
            "dynseg_torch.utils.profiling, dynseg_torch.probes.dp_parity, "
            "dynseg_torch.probes.kernel_times, dynseg_torch.probes.conv_layouts; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax')); "
            "assert not bad, bad; "
            "assert 'dynseg_torch.ops._build' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_command_line_imports_no_jax():
    """An operation driven through dynseg_torch.cli.main (check_data, the
    host-only one) and the parser's --help import no jax either."""
    code = "\n".join([
        "import contextlib, io, sys",
        "from dynseg_torch.cli import main",
        "rc = main(['--operation', 'check_data', '--dataset', 'synthetic',",
        "           '--dataset_kwargs', '{\"size\": 32}', '--values', '9'])",
        "assert rc == 0, rc",
        "out = io.StringIO()",
        "with contextlib.redirect_stdout(out), contextlib.suppress(SystemExit):",
        "    main(['--help'])",
        "assert '--device' in out.getvalue()",
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax'))",
        "assert not bad, bad",
    ])
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_kernel_wrapper_raises_off_cpu():
    """A tensor that is not on the CPU must launch the kernel or raise;
    `meta` has no kernel, so it raises and the plain version is not run."""
    x = torch.zeros((1, 8, 8, 128), dtype=torch.int8, device="meta")
    w = torch.zeros((3, 3, 128, 128), dtype=torch.int8, device="meta")
    a = torch.zeros(128, device="meta")
    before = int8_conv.launches
    with pytest.raises(RuntimeError, match="no kernel"):
        int8_conv.int8_block_conv(x, w, a, a, dilation=5, leaky_slope=0.1,
                                  out_scale=0.05)
    assert int8_conv.launches == before


def test_gather_wrapper_raises_off_cpu():
    images = torch.zeros((1, 16, 16, 3), dtype=torch.uint8, device="meta")
    masks = torch.zeros((1, 16, 16), dtype=torch.uint8, device="meta")
    m = torch.zeros(3, device="meta")
    pos = torch.zeros((2, 3), dtype=torch.int32, device="meta")
    aug = torch.zeros(2, dtype=torch.int32, device="meta")
    before = gather.launches
    with pytest.raises(RuntimeError, match="no kernel"):
        gather.gather_batch(images, masks, m, m, pos, aug, 9)
    assert gather.launches == before


def test_pool_bwd_wrapper_raises_off_cpu():
    x = torch.zeros((1, 8, 8, 16), device="meta")
    before = pool.launches
    with pytest.raises(RuntimeError, match="no kernel"):
        pool.pallas_pool_bwd(x, x, x, 3)
    assert pool.launches == before


@pytest.mark.parametrize("variant", [None, "twopass", "fused"])
def test_pool_bwd_wrapper_raises_off_cpu_for_every_variant(variant):
    """Naming a variant does not reach a kernel for a `meta` tensor either;
    no count moves."""
    x = torch.zeros((1, 8, 8, 16), device="meta")
    before = (pool.launches, dict(pool.variant_launches))
    with pytest.raises(RuntimeError, match="no kernel"):
        pool.pallas_pool_bwd(x, x, x, 3, variant)
    assert (pool.launches, pool.variant_launches) == before


@pytest.mark.parametrize("size", [25, 65, 129])
def test_gather_wrapper_raises_off_cpu_at_every_size(size):
    """A `meta` batch raises at any window size: the shared-memory gate of
    the earlier kernel is gone, and no count moves."""
    images = torch.zeros((1, 200, 200, 5), dtype=torch.float32, device="meta")
    masks = torch.zeros((1, 200, 200), dtype=torch.int32, device="meta")
    m = torch.zeros(5, device="meta")
    pos = torch.zeros((2, 3), dtype=torch.int32, device="meta")
    aug = torch.zeros(2, dtype=torch.int32, device="meta")
    before = gather.launches
    with pytest.raises(RuntimeError, match="no kernel"):
        gather.gather_batch(images, masks, m, m, pos, aug, size)
    assert gather.launches == before
