"""dynseg_torch stands alone on a machine without JAX, and its kernel
wrappers never quietly fall back to the plain versions."""

import subprocess
import sys

import pytest
import torch

from dynseg_torch.ops import gather, int8_conv, pool


def test_package_imports_no_jax():
    code = ("import sys, dynseg_torch, dynseg_torch.infer, dynseg_torch.ops.quant, "
            "dynseg_torch.bridge, dynseg_torch.train, dynseg_torch.cli, "
            "dynseg_torch.ops.gather, dynseg_torch.ops.pool; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax')); "
            "assert not bad, bad; "
            "assert 'dynseg_torch.ops._build' not in sys.modules")
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
