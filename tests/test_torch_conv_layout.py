"""The memory layout each float conv reaches cuDNN in
(`models.blocks.routes_nchw`): which blocks the rule routes to NCHW, that
the routed conv computes what the channels_last one does in all three
passes, and the counter `models.blocks.conv_layouts`."""

import numpy as np
import pytest
import torch
from torch import nn

from dynseg_torch.config import ModelConfig
from dynseg_torch.models import blocks, dilated
from dynseg_torch.models.blocks import conv, routes_nchw
from dynseg_torch.models.dilated import _ARCH, build_model
from dynseg_torch.probes import conv_layouts

NETS = sorted(_ARCH) + ["dilated_icpr_rate6_densely"]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers on one machine: torch's default of
    one intra-op thread per core oversubscribes it many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _counters_left_as_found():
    """These tests run full-width forwards; other tests in the process
    read the module counters (`assembly`, `conv_layouts`) through a run."""
    saved = dict(dilated.assembly), dict(blocks.conv_layouts)
    yield
    dilated.assembly.update(saved[0])
    blocks.conv_layouts.update(saved[1])


def _model(net_type, dtype="float32", width=1.0):
    cfg = ModelConfig(net_type=net_type, num_classes=6, num_input_bands=3,
                      width_multiplier=width, compute_dtype=dtype)
    return build_model(cfg, 3)


@pytest.mark.parametrize("net_type", NETS)
def test_rule_routes_densely_block5_alone(net_type):
    """At full width in float32 the rule routes the densely net's block 5
    (Cin 643, k3, d6) and no other block of the five nets; the heads
    take the default layout. In bfloat16 it routes nothing."""
    model = _model(net_type)
    routed = [i for i, b in enumerate(model.blocks) if b.nchw]
    assert routed == ([5] if net_type == "dilated_icpr_rate6_densely" else [])
    assert not any(b.nchw for b in _model(net_type, "bfloat16").blocks)


@pytest.mark.parametrize("cin,k,d,want", [
    (643, 3, 6, True), (513, 3, 3, True), (704, 3, 8, True), (576, 3, 3, True),
    (512, 3, 6, False), (643, 3, 1, False), (643, 3, 2, False), (643, 4, 6, False), (896, 1, 1, False),
    (256, 3, 6, False), (192, 3, 8, False),
])
def test_rule_band(cin, k, d, want):
    """The band of PERF.md section 5's layout table: 3x3, Cin above 512,
    dilation 3 or more, float32."""
    assert routes_nchw(cin, k, d, torch.float32) is want
    assert routes_nchw(cin, k, d, torch.bfloat16) is False


def test_probe_covers_every_conv_of_the_nets_and_the_band():
    """The probe that the rule rests on times each net's convs and the
    3x3 grid, each shape once."""
    shapes = conv_layouts.shapes()
    keys = [s[1:] for s in shapes]
    assert len(keys) == len(set(keys))
    assert (643, 256, 3, 6) in keys and (896, 6, 1, 1) in keys
    for net_type in NETS:
        model = _model(net_type)
        for layer in [b.conv for b in model.blocks] + [model.head.conv]:
            assert (layer.in_channels, layer.out_channels, layer.kernel_size[0],
                    layer.dilation[0]) in keys
    assert {(c, d) for c, _, k, d in keys if k == 3 and c >= 512} >= {
        (c, d) for c in conv_layouts.GRID_CIN for d in conv_layouts.GRID_DILATIONS}


@pytest.mark.parametrize("bias", [False, True], ids=["bn", "bias"])
def test_routed_conv_equals_channels_last(bias):
    """At Cin 643, k3, d6 on a small image the routed conv's forward,
    input gradient and weight gradient equal the channels_last conv's
    within 1e-5 relative; its output is channels_last, and the
    parameter keeps its layout."""
    torch.manual_seed(0)
    layer = nn.Conv2d(643, 32, 3, padding="same", dilation=6, bias=bias).to(
        memory_format=torch.channels_last)
    x0 = torch.randn(2, 643, 13, 11).contiguous(memory_format=torch.channels_last)
    g = torch.randn(2, 32, 13, 11)
    out = {}
    for nchw in (False, True):
        layer.zero_grad()
        x = x0.clone().requires_grad_(True)
        y = conv(layer, x, nchw)
        y.backward(g)
        out[nchw] = (y.detach(), x.grad, layer.weight.grad.clone())
        assert y.is_contiguous(memory_format=torch.channels_last)
        assert layer.weight.is_contiguous(memory_format=torch.channels_last)
    for a, b in zip(out[False], out[True]):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(a.abs().max()))


def _counted(model, train=False):
    blocks.reset_conv_layouts()
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(1, 9, 7, 3)).astype(np.float32))
    with torch.enable_grad() if train else torch.no_grad():
        y = model.train(train)(x)
        if train:
            y.sum().backward()
    return dict(blocks.conv_layouts)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("net_type", NETS)
def test_counter_reads_the_routes_of_a_forward(net_type, train):
    """One forward counts every float conv by its route: 1 `nchw` (block
    5) and 6 `channels_last` in the densely net, 0 `nchw` in a sequential
    one (its blocks and head channels_last)."""
    model = _model(net_type)
    n = len(model.blocks) + 1
    want = ({"channels_last": n - 1, "nchw": 1} if net_type == "dilated_icpr_rate6_densely"
            else {"channels_last": n, "nchw": 0})
    assert _counted(model, train) == want
    blocks.reset_conv_layouts()
    assert blocks.conv_layouts == {"channels_last": 0, "nchw": 0}


def test_export_counts_nothing_and_keeps_the_route():
    """torch.export traces the full-width densely net, block 5 routed:
    the counter stays as it was and the exported program computes what
    the eager forward does."""
    from torch.export import Dim

    model = _model("dilated_icpr_rate6_densely")
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 9, 11, 3)).astype(np.float32))
    blocks.reset_conv_layouts()
    dims = {0: Dim("b", min=1), 1: Dim("h", min=1), 2: Dim("w", min=1)}
    prog = torch.export.export(model, (x,), dynamic_shapes=(dims,))
    assert blocks.conv_layouts == {"channels_last": 0, "nchw": 0}
    with torch.no_grad():
        np.testing.assert_allclose(prog.module()(x).numpy(), model(x).numpy(),
                                   rtol=1e-5, atol=1e-5)
