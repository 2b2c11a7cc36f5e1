"""The control of a cell's comparison: the plain reference put in the
program's place, computed in the nearest precision below the one the
configuration states (TF32 for float32 with TF32 off), and, for training,
the reference with half of each batch left out; each judged by the cell's
own comparison against the full-precision reference.

    python -m portbench.control --workload <cell> --seeds 1,2,3

prints one JSON line per seed: the numbers each reads, beside the cell's
limits. A control run needs the card for the cell's own sizes; the
benchmark's own runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

from portbench import synth
from portbench.run import Run, load_module


def _train_batches(r, images, masks, rng):
    """The checked steps' batches drawn here (labelled centres, uniform;
    augment ids uniform), at every other patch size of the mix."""
    x = r.mix
    pad = max(x["values"]) // 2 + 1
    sizes = x["values"][::2]
    fed = []
    for step in range(x["checked_steps"]):
        size = sizes[step % len(sizes)]
        pos = []
        while len(pos) < x["batch_size"]:
            t = int(rng.integers(len(masks)))
            h, w = masks[t].shape
            rr, cc = int(rng.integers(h)), int(rng.integers(w))
            if int(masks[t][rr, cc]) != 255:
                pos.append((t, rr + pad, cc + pad))
        fed.append((size, np.array(pos), rng.integers(0, 8, x["batch_size"])))
    return fed, pad


def readings(r) -> dict:
    """{variant: numbers} of the cell's control at seed r.seed."""
    driver = load_module(r.pkg / "drivers" / f"{r.mix['driver']}.py",
                         f"portbench_driver_{r.mix['driver']}")
    data = r.config["data"]
    dev = torch.device(r.device)
    rng = np.random.default_rng([r.seed % 2 ** 63, 0xC0])
    if r.mix["driver"] == "train":
        images, masks = synth.make_tiles(data, "train", r.seed, dev)
        mean, std = synth.stats(images)
        weights = synth.make_weights(r.net, r.seed, dev)
        p0 = {k: v.cpu() for k, v in weights.items() if ".running_" not in k}
        fed, pad = _train_batches(r, images, [m.cpu().numpy() for m in masks], rng)
        hw = [tuple(im.shape[:2]) for im in images]
        args = (r, p0, fed, images, masks, hw, mean, std, pad)
        ref = driver.reference_steps(*args)
        out = {"tf32": driver.gaps(driver.reference_steps(*args, tf32=True), ref, p0),
               "half_batch": driver.gaps(driver.reference_steps(*args, half=True), ref, p0)}
        out["unchanged"] = driver.gaps(dict(ref, params=p0), ref, p0)
        return out
    images, _ = synth.make_tiles(data, "val", r.seed, dev)
    mean, std = synth.stats(images)
    weights = synth.make_weights(r.net, r.seed, dev)
    synth.bn_from_crops(weights, r.net, images, mean, std, r.seed)
    kept = []
    while len(kept) < r.mix["check_rects_max"]:
        t = len(kept) // r.mix["check_rects_per_tile"] % len(images)
        for rect in driver.rects_for(rng, *images[t].shape[:2], r.mix["check_side"],
                                     r.mix["check_rects_per_tile"]):
            kept.append((t, rect, None))
    kept = kept[:r.mix["check_rects_max"]]
    ref = driver.reference_probs(r, weights, images, mean, std, kept)
    ctl = driver.reference_probs(r, weights, images, mean, std, kept, tf32=True)
    answers = [(p.argmax(-1).cpu().numpy(), p.cpu().numpy() if r.mix["probs"] else None)
               for p in ctl]
    found = driver.numbers(answers, ref)
    return {"tf32": found}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("portbench.control: no CUDA card", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent.parent
    for seed in (int(s) for s in args.seeds.split(",")):
        r = Run(root, args.workload, seed, 0.0, False, args.device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "readings": readings(r), "limits": r.limits}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
