"""Paired comparison of the port's accuracy studies with the JAX runs.

Since `Trainer.init_state(seed)` draws the JAX package's initial weights
for `seed`, and the data, sampler and scheduler streams were already the
same, a port run and the JAX run of the same configuration and seed start
from the same weights and see the same patches: each (config, seed) is a
pair. This reads the committed JSONs of both sides and prints, per study,
the paired differences d = port - JAX:

  * sched_ablation (run a): d of test OA for every (config, seed) over
    both seed groups, pooled: n, mean, SD, 95% t-interval and the verdict
    of the rule in PERF.md §6 (the interval holds 0 or not); the Pearson
    correlation of port and JAX OA; the same for each JAX JSON (seed
    group) alone, and for the earlier unpaired port runs
    (`docs/torch_sched_ablation_*.json`, drawn with the numpy init)
    against the same JAX runs; each side's mean per config over all seeds
    and whether every dynamic schedule is above every single_fixed;
  * mode_gap (b): window and dense OA per (regime, seed);
  * bf16_eval (c): the four arms' OA per seed;
  * parity_bracket (d): mean F1 per combination, and on each side the
    means over the combinations with BatchNorm on / off and
    favor_high_score True / False (the combinations both sides ran);
  * diagnose_collapse and ema_recalib_probe (e), where their JSONs exist:
    final and best OA (best_iter) per cell (the six cells ran as two
    calls, `_1` and `_2`); raw, EMA with live BN and recalibrated OA.

    python -m dynseg_torch.probes.paired_stats [--out PATH]

A JSON the port has not written yet is reported as missing. numpy and
scipy only.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from scipy import stats

DOCS = "docs"
# (port JSON, JAX JSON, the JAX JSON's first seed: its runs are in seed
# order and older JSONs carry no seed_start).
SCHED = (("torch_paired_sched_ablation_s012.json", "sched_ablation.json", 0),
         ("torch_paired_sched_ablation_s34.json", "sched_ablation_s34.json", 3))
SCHED_UNPAIRED = (("torch_sched_ablation_s012.json", "sched_ablation.json", 0),
                  ("torch_sched_ablation_s34.json", "sched_ablation_s34.json", 3))
DYNAMIC = ("multi_fixed", "uniform", "multinomial")


def _load(name: str, docs: str):
    path = os.path.join(docs, name)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def paired(d: Sequence[float]) -> dict:
    """n, mean, SD and the 95% t-interval of paired differences."""
    d = np.asarray(d, np.float64)
    n = len(d)
    mean, sd = float(d.mean()), float(d.std(ddof=1))
    half = float(stats.t.ppf(0.975, n - 1) * sd / np.sqrt(n))
    return {"n": n, "mean": mean, "sd": sd, "ci95": [mean - half, mean + half],
            "t_crit": float(stats.t.ppf(0.975, n - 1))}


def sched_oa(port: dict, jax: dict, jax_seed_start: int) -> Dict[Tuple[str, int], Tuple[float, float]]:
    """(config, seed) -> (port OA, JAX OA) for the configs both ran."""
    want = {}
    for r in jax["results"]:
        for i, run in enumerate(r["runs"]):
            want[r["config"], jax_seed_start + i] = run["oa"]
    got = {(r["config"], run["seed"]): run["oa"] for r in port["results"] for run in r["runs"]}
    return {k: (got[k], want[k]) for k in sorted(got) if k in want}


def sched_report(groups, docs: str) -> Optional[dict]:
    pairs: Dict[Tuple[str, int], Tuple[float, float]] = {}
    by_group = {}
    for port_name, jax_name, start in groups:
        port, jax = _load(port_name, docs), _load(jax_name, docs)
        if port is None or jax is None:
            return None
        group = sched_oa(port, jax, start)
        pairs.update(group)
        p, j = (np.array([v[i] for v in group.values()]) for i in (0, 1))
        by_group[jax_name] = {**paired(p - j), "pearson_r": float(np.corrcoef(p, j)[0, 1])}
    keys = sorted(pairs)
    p = np.array([pairs[k][0] for k in keys])
    j = np.array([pairs[k][1] for k in keys])
    out = paired(p - j)
    out["verdict"] = ("no systematic difference shown" if out["ci95"][0] <= 0 <= out["ci95"][1]
                      else "a shown difference")
    out["pearson_r"] = float(np.corrcoef(p, j)[0, 1])
    out["by_jax_json"] = by_group
    configs = sorted({c for c, _ in keys})
    means = {side: {c: float(np.mean([pairs[k][i] for k in keys if k[0] == c]))
                    for c in configs} for i, side in enumerate(("port", "jax"))}
    out["config_means"] = means
    out["ordering_holds"] = {}
    for side, m in means.items():
        dyn = [m[c] for c in configs if c in DYNAMIC]
        fixed = [m[c] for c in configs if c.startswith("single_fixed")]
        out["ordering_holds"][side] = bool(dyn and fixed and min(dyn) > max(fixed))
    out["pairs"] = [{"config": c, "seed": s, "port": pairs[c, s][0], "jax": pairs[c, s][1],
                     "d": pairs[c, s][0] - pairs[c, s][1]} for c, s in keys]
    return out


def _with_stats(rows: List[dict]) -> dict:
    """Per-row differences and, for each d_ column, the paired statistic."""
    keys = [k for k in rows[0] if k.startswith("d_")] if rows else []
    return {"rows": rows,
            "stats": {k: paired([r[k] for r in rows]) for k in keys} if len(rows) > 1 else {}}


def mode_gap_report(port: dict, jax: dict) -> dict:
    want = {(r["train"], r["seed"]): r for r in jax["rows"]}
    return _with_stats([{"train": r["train"], "seed": r["seed"],
                         **{f"d_{m}": r[m]["oa"] - want[r["train"], r["seed"]][m]["oa"]
                            for m in ("window", "dense")}}
                        for r in port["rows"] if (r["train"], r["seed"]) in want])


def bf16_report(port: dict, jax: dict) -> dict:
    want = {r["seed"]: r for r in jax["per_seed"]}
    arms = ("window_f32", "window_bf16", "dense_f32", "dense_bf16")
    return _with_stats([{"seed": r["seed"],
                         **{f"d_{a}": r[a]["oa"] - want[r["seed"]][a]["oa"] for a in arms}}
                        for r in port["per_seed"] if r["seed"] in want])


_KNOBS = ("favor_high_score", "update_type", "leaky_slope", "use_batch_norm")


def bracket_report(port: list, jax: list) -> dict:
    want = {tuple(r[k] for k in _KNOBS): r["mean_f1"] for r in jax}
    rows = [{**{k: r[k] for k in _KNOBS}, "port": r["mean_f1"],
             "jax": want[tuple(r[k] for k in _KNOBS)],
             "d": r["mean_f1"] - want[tuple(r[k] for k in _KNOBS)]}
            for r in port if tuple(r[k] for k in _KNOBS) in want]
    marginals = {}
    for knob in ("use_batch_norm", "favor_high_score"):
        for value in (True, False):
            sel = [r for r in rows if r[knob] == value]
            marginals[f"{knob}={value}"] = {
                side: float(np.mean([r[side] for r in sel])) for side in ("port", "jax")}
    p, j = (np.array([r[side] for r in rows]) for side in ("port", "jax"))
    return {"n": len(rows), "d": paired(p - j), "pearson_r": float(np.corrcoef(p, j)[0, 1]),
            "marginals": marginals, "rows": rows}


def collapse_report(port: dict, jax: dict) -> dict:
    want = {(r["distribution"], r["seed"]): r for r in jax["results"]}
    out = []
    for r in port["results"]:
        w = want.get((r["distribution"], r["seed"]))
        if w is None:
            continue
        out.append({"cell": f"{r['distribution']}:{r['seed']}",
                    "port": [r["final_oa"], r["best_oa"], r["best_iter"]],
                    "jax": [w["final_oa"], w["best_oa"], w["best_iter"]],
                    "d_final": r["final_oa"] - w["final_oa"],
                    "d_best": r["best_oa"] - w["best_oa"]})
    return _with_stats(out)


def ema_probe_report(port: dict, jax: dict) -> dict:
    out = {"d_raw_final": port["raw_final"]["oa"] - jax["raw_final"]["oa"],
           "d_ema_live_bn": port["ema_live_bn"]["oa"] - jax["ema_live_bn"]["oa"]}
    for n, v in port["ema_recalibrated"].items():
        if n in jax["ema_recalibrated"]:
            out[f"d_recalibrated_{n}"] = v["oa"] - jax["ema_recalibrated"][n]["oa"]
    return out


def report(docs: str = DOCS) -> dict:
    """Every paired comparison whose JSONs exist under `docs`."""
    out = {"sched_ablation": sched_report(SCHED, docs),
           "sched_ablation_unpaired": sched_report(SCHED_UNPAIRED, docs)}
    for key, port_name, jax_name, fn in (
            ("mode_gap", "torch_paired_mode_gap.json", "mode_gap.json", mode_gap_report),
            ("bf16_eval", "torch_paired_bf16_eval.json", "bf16_eval.json", bf16_report),
            ("bracket_texture", "torch_paired_bracket_texture.json", "bracket_texture.json",
             bracket_report),
            ("collapse_diag", ("torch_paired_collapse_diag_1.json",
                               "torch_paired_collapse_diag_2.json"), "collapse_diag.json",
             collapse_report),
            ("collapse_ema_keep", "torch_paired_collapse_ema_keep.json",
             "collapse_ema_keep.json", collapse_report),
            ("ema_recalib_probe", "torch_paired_collapse_ema_recalib_probe.json",
             "ema_recalib_probe.json", ema_probe_report)):
        if isinstance(port_name, tuple):  # one study run as several calls
            parts = [_load(name, docs) for name in port_name]
            port = None if None in parts else {
                "results": [r for part in parts for r in part["results"]]}
        else:
            port = _load(port_name, docs)
        jax = _load(jax_name, docs)
        out[key] = None if port is None or jax is None else fn(port, jax)
    return out


def _field(key: str, value) -> str:
    if key.startswith("d_"):
        return f"{key} {value:+.4f}"
    if isinstance(value, list):  # OA, OA, iteration
        return f"{key} " + " / ".join(f"{v:.4f}" if isinstance(v, float) else str(v)
                                      for v in value)
    return f"{key} {value}"


def _print(rep: dict) -> None:
    for key in ("sched_ablation", "sched_ablation_unpaired"):
        r = rep[key]
        if r is None:
            print(f"{key}: missing")
            continue
        print(f"{key}: n {r['n']}, d mean {r['mean']:+.4f}, SD {r['sd']:.4f}, 95% CI "
              f"[{r['ci95'][0]:+.4f}, {r['ci95'][1]:+.4f}] (t {r['t_crit']:.4f}): "
              f"{r['verdict']}; Pearson r {r['pearson_r']:+.3f}")
        for name, g in r["by_jax_json"].items():
            print(f"  against {name}: n {g['n']}, d mean {g['mean']:+.4f}, SD {g['sd']:.4f}, "
                  f"95% CI [{g['ci95'][0]:+.4f}, {g['ci95'][1]:+.4f}]; Pearson r "
                  f"{g['pearson_r']:+.3f}")
        print(f"  ordering (every dynamic above every single_fixed): {r['ordering_holds']}")
        for c in sorted(r["config_means"]["port"], key=lambda c: -r["config_means"]["port"][c]):
            print(f"  {c:<18} port {r['config_means']['port'][c]:.4f}  "
                  f"jax {r['config_means']['jax'][c]:.4f}")
    for key in ("mode_gap", "bf16_eval", "bracket_texture", "collapse_diag",
                "collapse_ema_keep", "ema_recalib_probe"):
        r = rep[key]
        if r is None:
            print(f"{key}: missing")
        elif key == "bracket_texture":
            d = r["d"]
            print(f"{key}: {r['n']} combinations, d mean {d['mean']:+.4f}, SD {d['sd']:.4f}, "
                  f"95% CI [{d['ci95'][0]:+.4f}, {d['ci95'][1]:+.4f}]; Pearson r "
                  f"{r['pearson_r']:+.3f}")
            for name, m in r["marginals"].items():
                print(f"  {name}: port {m['port']:.4f}  jax {m['jax']:.4f}")
        elif isinstance(r, dict) and "rows" in r:
            print(f"{key}:")
            for row in r["rows"]:
                print("  " + ", ".join(_field(k, v) for k, v in row.items()))
            for k, st in r["stats"].items():
                print(f"  {k}: n {st['n']}, mean {st['mean']:+.4f}, SD {st['sd']:.4f}, 95% CI "
                      f"[{st['ci95'][0]:+.4f}, {st['ci95'][1]:+.4f}]")
        else:
            print(f"{key}: {json.dumps(r)}")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m dynseg_torch.probes.paired_stats",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--docs", default=DOCS, help="where both sides' JSONs are")
    ap.add_argument("--out", default="", help="also write the report as JSON here")
    args = ap.parse_args(argv)
    rep = report(args.docs)
    _print(rep)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rep, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
