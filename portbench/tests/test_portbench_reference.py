"""The plain reference on the CPU at width 0.125: pinned for the two
sequential nets, and held to the port for the dense-wired one.

The pins are sha256 digests (first 16 hex digits) of the weights drawn
from the seed and of the reference's train, eval and int8 outputs and two
training steps, as the harness computed them when each configuration's net
was still a table in its code: taking the net from the configuration moved
no bit. They hold on one CPU build of torch, on one thread: the CPU's
weight gradients are summed in an order that follows the thread count.

The dense wiring (SURVEY.md C7) is compared with the port's
`DilatedDenseNet` and `ops.quant._forward` (K5's CPU implementation), from
the same seeded weights; each tolerance says why it is what it is, and a
reference that leaves one block's map out of a concat fails each."""

import hashlib
import json

import pytest
import torch

import tiny
from portbench import counts, synth
from portbench.reference import net as ref_net
from portbench.reference import segment as ref_seg
from portbench.reference import train as ref_train

SEED = 2 ** 31 + 11
WIDTH = 0.125
MIN_CH = 16  # at width 0.125, the int8 plan's blocks of the full-width net at 128

PINS = {
    "icpr_rate6-vaihingen": {"weights": "b2b91afeca54a1c1", "running": "cf8b9c9da9ddc568",
                             "train": "606267f08290c4df", "eval": "960b4204d9652766",
                             "int8": "fefaad2445c87f64", "steps": "1c3ffca752acc68b"},
    "grsl_rate8-potsdam": {"weights": "362ff86d57cff4bf", "running": "3244ca43ffde659d",
                           "train": "3e92eb99eaaa5150", "eval": "020640cb4e49d946",
                           "int8": "116aae83c5efc0e7", "steps": "1c33c7dcb02f6d8f"},
}


def model_of(config: str, **over) -> dict:
    path = tiny.REPO / "portbench" / "configs" / f"{config}.json"
    return dict(json.loads(path.read_text())["model"], width_multiplier=WIDTH, **over)


def digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def setup(model: dict):
    """The net, seeded weights with BatchNorm statistics from crops, the
    tiles' calibration crops and an input batch."""
    net = counts.net(model)
    w = synth.make_weights(net, SEED, "cpu")
    drawn = digest([w[k] for k in sorted(w)])
    images, _ = synth.make_tiles(tiny.TINY_DATA, "val", SEED, "cpu")
    mean, std = synth.stats(images)
    synth.bn_from_crops(w, net, images, mean, std, SEED)
    crops = ref_seg.calib_crops(images, torch.as_tensor(mean), torch.as_tensor(std), 8)
    x = torch.randn((2, 20, 24, 3), generator=torch.Generator().manual_seed(5))
    return net, w, drawn, crops, x


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("config", sorted(PINS))
def test_reference_outputs_are_pinned(one_thread, config):
    net, w, drawn, crops, x = setup(model_of(config))
    st: list = []
    train = ref_net.forward(w, x, net, train=True, stats=st)
    plan = ref_seg.quantize(w, net, crops, 99.9, MIN_CH)
    q = [b for b in plan["blocks"] if b]
    lab = torch.randint(0, 7, (2, 20, 24), generator=torch.Generator().manual_seed(6))
    lab[lab == 6] = 255
    p0 = {k: v for k, v in w.items() if ".running_" not in k}
    steps = ref_train.train_steps(p0, [(x, lab), (x.flip(1), lab.flip(1))], net,
                                  0.01, 0.9, 5e-4)
    got = {
        "weights": drawn,
        "running": digest([w[k] for k in sorted(w)]),
        "train": digest([train] + [t for pair in st for t in pair]),
        "eval": digest([ref_net.forward(w, x, net)]),
        "int8": digest([ref_net.forward(w, x, net, quant=plan)] + [b["wq"] for b in q]
                       + [b["a"] for b in q] + [b["b"] for b in q]),
        "steps": digest([torch.tensor(steps["losses"])]
                        + [steps["m1"][k] for k in sorted(steps["m1"])]
                        + [steps["params"][k] for k in sorted(steps["params"])]),
    }
    assert got == PINS[config]


# --------------------------------------------------------------------- #
# dense wiring against the port
# --------------------------------------------------------------------- #
def densely() -> dict:
    return model_of("icpr_rate6-vaihingen", net_type="dilated_icpr_rate6_densely",
                    wiring="dense")


def port_model(train: bool):
    """The port's DilatedDenseNet with the seeded weights; BatchNorm
    momentum 0, so that a train-mode forward leaves the batch statistics
    as its running ones."""
    from dynseg_torch.config import ModelConfig
    from dynseg_torch.models.dilated import DilatedDenseNet, build_model

    mcfg = ModelConfig(net_type="dilated_icpr_rate6_densely", num_classes=6,
                       width_multiplier=WIDTH, bn_momentum=0.0)
    net, w, _, crops, x = setup(densely())
    model = build_model(mcfg, 3)
    assert isinstance(model, DilatedDenseNet)
    model.load_state_dict(w, strict=False)  # no num_batches_tracked: not read
    return mcfg, model.train(train), net, w, crops, x


def leave_out_one(monkeypatch):
    """A fault: every concat of the reference zeros its last map but one
    (block i >= 2 reads no block i-2 map, the head no block-4 map)."""
    real = ref_net.concat

    def broken(maps):
        if len(maps) > 2:
            maps = maps[:-2] + [torch.zeros_like(maps[-2])] + maps[-1:]
        return real(maps)

    monkeypatch.setattr(ref_net, "concat", broken)


# float32 on both sides, different summation orders (cuDNN-free CPU convs,
# channels_last against NCHW, ATen's "same" against an explicit pad): the
# measured gap is under 1e-6 of the logits' scale; 1e-4 leaves room for
# other CPU builds, and a concat left out moves the logits by ~0.5 of it.
FLOAT_TOL = 1e-4
# The batch statistics: mean and biased variance of the same float32 maps,
# reduced in another order: measured under 1.2e-6 relative.
STATS_TOL = 1e-5
# int8: integer sums are exact on both sides; a float32 concat input that
# lands within rounding of a code edge may flip one code by one step, a
# 1/127 of the block's range weighed by one of k^2 x cin weights. Measured
# 2e-7 of the logits' scale (no flip); 1e-3 admits a few flips, not a
# missing map (~0.5).
INT8_TOL = 1e-3


def gap(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("fault", [False, True])
def test_dense_eval_forward_is_the_ports(monkeypatch, fault):
    _, model, net, w, _, x = port_model(train=False)
    with torch.no_grad():
        port = model(x)
    if fault:
        leave_out_one(monkeypatch)
    got = gap(port, ref_net.forward(w, x, net))
    assert (got > 100 * FLOAT_TOL) if fault else (got < FLOAT_TOL), got


@pytest.mark.parametrize("fault", [False, True])
def test_dense_train_statistics_are_the_ports(monkeypatch, fault):
    _, model, net, w, _, x = port_model(train=True)
    with torch.no_grad():
        port = model(x)
    if fault:
        leave_out_one(monkeypatch)
    st: list = []
    ref = ref_net.forward(w, x, net, train=True, stats=st)
    gaps = [gap(port, ref)]
    for block, (mean, var) in zip(model.blocks, st):
        gaps += [gap(block.bn.running_mean, mean), gap(block.bn.running_var, var)]
    if fault:
        assert max(gaps) > 100 * STATS_TOL, gaps
    else:
        assert gaps[0] < FLOAT_TOL and max(gaps[1:]) < STATS_TOL, gaps


@pytest.mark.parametrize("fault", [False, True])
def test_dense_int8_plan_is_the_ports(monkeypatch, fault):
    """Calibration on the concat inputs, the int8 blocks (2-5 at MIN_CH)
    each quantizing its own concat, float32 out, pooled in float."""
    from dynseg_torch.ops import quant

    mcfg, _, net, w, crops, x = port_model(train=False)
    ranges = quant.calibrate(mcfg, w, crops, 99.9)
    qv = quant.quantize_variables(mcfg, w, ranges, 3, min_ch=MIN_CH)
    with torch.inference_mode():
        port = quant._forward(mcfg, qv, x)
    if fault:
        leave_out_one(monkeypatch)
    plan = ref_seg.quantize(w, net, crops, 99.9, MIN_CH)
    on = [i for i, b in enumerate(plan["blocks"]) if b]
    assert on == [2, 3, 4, 5]
    got = gap(port, ref_net.forward(w, x, net, quant=plan))
    if fault:
        assert got > 100 * INT8_TOL, got
        return
    assert got < INT8_TOL, got
    for i in on:
        b = plan["blocks"][i]
        # The range is a percentile of the same float32 concat (STATS_TOL),
        # the weights' codes the same numpy arithmetic (exact).
        assert abs(b["act_scale"] / float(qv[f"blocks.{i}.act_scale"]) - 1) < STATS_TOL
        assert torch.equal(b["wq"], qv[f"blocks.{i}.conv.weight"].float())
