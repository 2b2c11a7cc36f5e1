"""train.mfu: the share (%) of the float32 peak that the window's training
reached: forward, input-gradient (none for the input bands) and
weight-gradient operations of every completed step, from shapes, at 67
TFLOP/s (TF32 off), over the window's wall time."""

from portbench import counts, peaks


def read(r):
    if r.device != "cuda":
        return None  # a share of the card's peak exists only on the card
    w = r.window
    if not w.get("steps") or w["seconds"] <= 0:
        return None
    flops = sum(n * counts.train_step_flops(r.net, w["batch"][s], s)
                for s, n in w["steps"].items())
    return 100.0 * flops / peaks.FP32_FLOPS / w["seconds"]
