"""What the benchmark may import: nothing under portbench/ imports JAX or
the JAX package, and the plain reference imports nothing of the port
either. Top-level module names are compared whole, so dynseg_torch is not
dynseg."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parents[1]
JAX = {"jax", "jaxlib", "flax", "dynseg"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")), ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax_imports(path):
    assert not set(_imports(path)) & JAX


@pytest.mark.parametrize("path", sorted((PKG / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert not set(_imports(path)) & (JAX | {"dynseg_torch"})


_BLOCKER = """
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in {blocked!r}:
            raise ImportError('blocked: ' + name)
sys.meta_path.insert(0, Block())
"""


def _run_blocked(blocked, body):
    code = _BLOCKER.format(blocked=set(blocked)) + body
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=PKG.parent)


def test_reference_runs_without_the_port():
    proc = _run_blocked(JAX | {"dynseg_torch"}, """
import torch
from portbench import counts, synth
from portbench.reference import net, segment, train
import json
for name in ('grsl_rate8-potsdam', 'icpr_rate6-vaihingen'):
    model = json.load(open(f'portbench/configs/{name}.json'))['model']
    for over in ({}, {'wiring': 'dense'}):
        n = counts.net(dict(model, width_multiplier=0.125, **over))
        w = synth.make_weights(n, 1, 'cpu')
        y = net.forward(w, torch.zeros(1, 16, 16, 3), n, train=True)
        assert y.shape == (1, 16, 16, 6)
""")
    assert proc.returncode == 0, proc.stderr


def test_harness_modules_load_without_jax():
    proc = _run_blocked(JAX, """
import importlib, pathlib
from portbench.run import load_module
root = pathlib.Path('portbench')
for p in sorted(root.glob('*/*.py')) + sorted(root.glob('*.py')):
    if 'tests' not in p.parts:
        load_module(p, 'm_' + p.stem.replace('.', '_'))
import dynseg_torch.train, dynseg_torch.infer
""")
    assert proc.returncode == 0, proc.stderr
