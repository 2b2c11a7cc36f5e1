"""The dense-wired int8 forward (dilated_icpr_rate6_densely, `ops.quant`)
at full width on small rasters, from seeded weights of the benchmark's
configuration: against portbench's plain reference, and its feature
buffer (zero lead channels, each output written once into its slot, every
int8 block's input a 16-channel-aligned prefix) against the forward that
concatenated the growing list of maps at every block, bit for bit.

K5 runs its plain CPU body here (`int8_conv._plain`: an exact float64 sum
of the codes), on both sides alike."""

import contextlib
import itertools
import json
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from dynseg_torch.config import ModelConfig
from dynseg_torch.models.dilated import compute_dtype, to_nchw
from dynseg_torch.ops import int8_conv, quant
from portbench import counts, synth
from portbench.reference import net as ref_net
from portbench.reference import segment as ref_seg

CONFIG = (Path(__file__).resolve().parents[1] / "portbench" / "configs"
          / "icpr_rate6_densely-vaihingen.json")
NET = "dilated_icpr_rate6_densely"
LEAD = 13  # zero channels before the 3 bands: the input's slot is 16 wide


@pytest.fixture(autouse=True, scope="module")
def _four_torch_threads():
    """The suite runs several workers on one machine: torch's default of
    one intra-op thread per core oversubscribes it many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def _setup(seed: int, shape):
    """The configuration's net, its seeded weights with BatchNorm running
    statistics from crops of seeded 8-bit tiles, and an input batch."""
    net = counts.checked_net(json.loads(CONFIG.read_text())["model"])
    w = synth.make_weights(net, seed, "cpu")
    g = torch.Generator().manual_seed(seed)
    images = [torch.randint(0, 256, (40, 44, 3), dtype=torch.uint8, generator=g)
              for _ in range(2)]
    mean, std = synth.stats(images)
    synth.bn_from_crops(w, net, images, mean, std, seed, n=4, side=32)
    return net, w, torch.randn((*shape, 3), generator=g)


def _mcfg(dtype="float32"):
    return ModelConfig(net_type=NET, num_classes=6, compute_dtype=dtype)


def _concat_forward(mcfg, variables, x, record=None, calls=None):
    """The dense wiring as it ran before the feature buffer: every block
    reads the concat of the growing list of maps, and each int8 block's
    K5 operands are packed without a lead, at the concat's own Cin. The
    head is the port's: one matrix product over the pixels of the
    concatenated block outputs. With `calls`, each K5 call appends (its
    int8 input, its operands)."""
    dtype = compute_dtype(mcfg)
    feats = [to_nchw(x.float()).to(dtype)]
    for spec in quant.block_specs(mcfg, x.shape[-1]):
        p = quant._block_params(variables, spec)
        pc = None
        if "w_scale" in p:
            pc = int8_conv.pack_conv(
                p["conv.weight"].permute(2, 3, 1, 0), *quant._fold(mcfg, p),
                dilation=spec["dilation"], leaky_slope=mcfg.leaky_slope,
                out_dtype=dtype)
        with _recording(calls):
            out, _ = quant._block_forward(mcfg, spec, p, torch.cat(feats, dim=1),
                                          record, 99.9, pc)
        feats.append(out)
    h = torch.cat(feats[1:], dim=1).permute(0, 2, 3, 1)
    if record is not None:
        record["__head__"] = quant._percentile(h.abs(), 99.9)
    logits = F.linear(h, variables["head.conv.weight"].to(dtype)[:, :, 0, 0])
    return (logits + variables["head.conv.bias"].to(dtype)).float()


@contextlib.contextmanager
def _recording(calls):
    """Within it, every K5 call of `ops.quant` appends (x, operands) to
    `calls` (nothing where `calls` is None)."""
    real = quant.int8_block_conv_packed
    if calls is not None:
        quant.int8_block_conv_packed = lambda x, pc: calls.append((x, pc)) or real(x, pc)
    try:
        yield
    finally:
        quant.int8_block_conv_packed = real


def _quantized(mcfg, w, crops, min_ch):
    ranges = quant.calibrate(mcfg, w, crops)
    return ranges, quant.quantize_variables(mcfg, w, ranges, 3, min_ch=min_ch)


# Every block int8 (min_ch 3), so that both sides compute every block
# from the same codes with exact integer sums and the same float32
# epilogue arithmetic (A*acc, + B, leaky-ReLU, the pool): what is left is
# the head's 896-channel float32 sum in another order, measured at
# 0.9-1.6e-6 of the logits' largest magnitude. One code that rounds the
# other way moves them by 3e-4 or more, and the float32 forward lies
# 2-5e-2 away: 2e-5 holds the first and refuses both.
LOGITS_TOL = 2e-5
# The calibration percentiles: the same float32 maps (both sides' float
# forwards, whose convolutions sum in another order), measured within
# 1.5e-6 relative.
RANGE_TOL = 1e-5


@pytest.mark.parametrize("seed,shape", [(3, (1, 21, 24)), (4, (2, 37, 29))],
                         ids=["1x21x24", "2x37x29"])
def test_dense_int8_forward_matches_plain_reference(monkeypatch, seed, shape):
    net, w, x = _setup(seed, shape)
    mcfg = _mcfg()
    crops = [x[i] for i in range(shape[0])]
    with torch.inference_mode():
        ranges, qv = _quantized(mcfg, w, crops, min_ch=3)
        got = quant._forward(mcfg, qv, x)
        own = ref_seg.quantize(w, net, crops, 99.9, 3)
        # The reference's plan at the port's ranges: each crop's record,
        # blocks then head, reads the port's range in turn.
        order = itertools.cycle([ranges[f"DilatedConvBlock_{i}"] for i in range(6)]
                                + [ranges["__head__"]])
        monkeypatch.setattr(ref_seg, "percentile", lambda t, pct: next(order))
        plan = ref_seg.quantize(w, net, crops, 99.9, 3)
        want = ref_net.forward(w, x, net, quant=plan)
    for i in range(6):
        port_scale = float(qv[f"blocks.{i}.act_scale"])
        assert plan["blocks"][i]["act_scale"] == port_scale
        assert abs(own["blocks"][i]["act_scale"] / port_scale - 1) < RANGE_TOL
        assert torch.equal(plan["blocks"][i]["wq"], qv[f"blocks.{i}.conv.weight"].float())
    gap = float((got - want).abs().max() / want.abs().max())
    assert gap < LOGITS_TOL, gap
    assert torch.equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("dtype,min_ch", [("float32", 128), ("bfloat16", 128),
                                          ("float32", 3)])
def test_aligned_forward_equals_the_concat_forward(dtype, min_ch):
    """The buffer's forward against the concat forward: the logits bit
    for bit; each int8 block's packed weights are the concat's behind
    LEAD zero rows, at a Cin that K5 takes on the tensor cores; and each
    K5 call's plain body on the padded prefix equals it on the concat,
    whose codes the prefix holds behind LEAD zero codes."""
    _, w, x = _setup(5, (2, 23, 19))
    mcfg = _mcfg(dtype)
    _, qv = _quantized(mcfg, w, [x[0], x[1]], min_ch)
    packed = quant.pack_blocks(mcfg, qv)
    assert sorted(packed) == [f"DilatedConvBlock_{i}"
                              for i in (range(2, 6) if min_ch == 128 else range(6))]
    for name, pc in packed.items():
        spec = next(s for s in quant.block_specs(mcfg, 3) if s["name"] == name)
        assert pc.cin == LEAD + spec["cin"] and pc.cin % 16 == 0
        assert pc.variant == "wgmma"
        assert not pc.w[:, :, :LEAD].any()
    aligned, concat = [], []
    with torch.inference_mode():
        with _recording(aligned):
            got = quant.make_apply(mcfg)(qv, x)
        want = _concat_forward(mcfg, qv, x, calls=concat)
    assert got.dtype == torch.float32 and torch.equal(got, want)
    assert len(aligned) == len(concat) == len(packed)
    for (xa, pa), (xc, pc) in zip(aligned, concat):
        assert pa.cin == xa.shape[-1] == LEAD + xc.shape[-1]
        assert not xa[..., :LEAD].any() and torch.equal(xa[..., LEAD:], xc)
        assert torch.equal(pa.w[:, :, LEAD:], pc.w)
        ya = int8_conv.int8_block_conv_packed_ref(xa, pa)
        assert torch.equal(ya, int8_conv.int8_block_conv_packed_ref(xc, pc))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_calibration_ranges_equal_the_concat_forwards(dtype):
    """Each block's range is the percentile of its concat input without
    the lead, and the head's of the block slots: bit for bit those of the
    concat forward."""
    _, w, x = _setup(6, (2, 26, 21))
    mcfg = _mcfg(dtype)
    crops = [x[0], x[1]]
    got = quant.calibrate(mcfg, w, crops)
    want: dict = {}
    with torch.inference_mode():
        for crop in crops:
            rec: dict = {}
            _concat_forward(mcfg, w, crop[None], record=rec)
            for name, val in rec.items():
                want[name] = max(want.get(name, 0.0), float(val))
    assert got == want


@pytest.mark.parametrize("min_ch", [128, 3])
def test_slot_stores_and_the_in_place_head_equal_the_copying_forward(monkeypatch, min_ch):
    """The forward whose pools store into the buffer's slots and whose
    head reads the slots in place, as one matrix product whose rows lie
    the buffer's width apart, against the forward that pooled into maps
    of their own, copied each into its slot and copied the slots out for
    cuDNN's 1x1 head: the head's input equal bit for bit, and the logits
    within 1e-5 of their largest magnitude (the head's float32 sum runs
    in another order)."""
    _, w, x = _setup(7, (2, 22, 25))
    mcfg = _mcfg()
    _, qv = _quantized(mcfg, w, [x[0], x[1]], min_ch)
    specs = quant.block_specs(mcfg, 3)
    packed = quant.pack_blocks(mcfg, qv)
    with torch.inference_mode():
        slots = quant._dense_forward(mcfg, qv, x, specs, None, 99.9, packed)
        got = quant._forward(mcfg, qv, x, packed=packed)
        monkeypatch.setattr(quant, "max_pool_fwd_into",
                            lambda y, window, scale, out: quant.max_pool_fwd(y, window, scale))
        copied = quant._dense_forward(mcfg, qv, x, specs, None, 99.9, packed)
        head_in = copied.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        want = F.conv2d(head_in, qv["head.conv.weight"]) + qv["head.conv.bias"][:, None, None]
    assert slots.shape == (2, 22, 25, 896) and slots.stride(2) == LEAD + 3 + 896
    assert torch.equal(slots, copied)
    want = want.permute(0, 2, 3, 1)
    gap = float((got - want).abs().max() / want.abs().max())
    assert gap < 1e-5, gap
