"""dynseg_torch.probes.paired_stats: the paired comparison of the port's
study JSONs with the JAX runs' (numpy and scipy only, no device).

* The pooled statistic is scipy's paired t-test interval.
* JAX runs, which carry no seed, pair by their order from the JSON's
  first seed; configs one side lacks drop out.
* The bracket's marginals average the combinations both sides ran.
* On the committed JSONs: the paired port runs and the earlier unpaired ones
  each give 40 pairs (24 against the seeds 0-2 JSON, 16 against 3-4), and
  every report prints (a missing JSON as "missing").
"""

import json

import numpy as np
import pytest
from scipy import stats

from dynseg_torch.probes import paired_stats


def test_paired_interval_is_scipys_paired_t_test():
    rng = np.random.default_rng(0)
    a, b = rng.normal(0.9, 0.03, 40), rng.normal(0.91, 0.03, 40)
    got = paired_stats.paired(a - b)
    ci = stats.ttest_rel(a, b).confidence_interval(0.95)
    assert got["n"] == 40
    np.testing.assert_allclose(got["ci95"], [ci.low, ci.high], rtol=1e-12)
    np.testing.assert_allclose(got["sd"], np.std(a - b, ddof=1), rtol=1e-12)
    assert got["t_crit"] == pytest.approx(2.0227, abs=1e-4)


def _sched(configs, seeds, with_seed=True, base=0.9):
    return {"results": [{"config": c, "runs": [
        {**({"seed": s} if with_seed else {}), "oa": base + 0.01 * i + 0.001 * s}
        for s in seeds]} for i, c in enumerate(configs)]}


def test_sched_pairs_by_seed_order_and_common_configs(tmp_path):
    (tmp_path / "port.json").write_text(json.dumps(
        _sched(["multi_fixed", "single_fixed@25"], [3, 4])))
    (tmp_path / "jax.json").write_text(json.dumps(
        _sched(["single_fixed@25", "multi_fixed", "uniform"], [3, 4], with_seed=False,
               base=0.8)))
    rep = paired_stats.sched_report((("port.json", "jax.json", 3),), str(tmp_path))
    assert rep["n"] == 4
    got = {(p["config"], p["seed"]): round(p["d"], 6) for p in rep["pairs"]}
    # port multi_fixed is config 0 (0.9), JAX's is config 1 (0.81).
    assert got == {("multi_fixed", 3): 0.09, ("multi_fixed", 4): 0.09,
                   ("single_fixed@25", 3): 0.11, ("single_fixed@25", 4): 0.11}
    assert rep["ordering_holds"] == {"port": False, "jax": True}
    assert paired_stats.sched_report((("port.json", "absent.json", 0),), str(tmp_path)) is None


def test_bracket_marginals_over_common_combinations():
    def row(favor, bn, f1):
        return {"favor_high_score": favor, "update_type": "acc", "leaky_slope": 0.1,
                "use_batch_norm": bn, "mean_f1": f1}

    jax = [row(True, True, 0.95), row(True, False, 0.93), row(False, True, 0.94),
           row(False, False, 0.92)]
    port = [row(True, True, 0.94), row(False, False, 0.93), row(False, True, 0.92)]
    rep = paired_stats.bracket_report(port, jax)
    assert rep["n"] == 3
    assert rep["marginals"]["use_batch_norm=True"] == pytest.approx(
        {"port": 0.93, "jax": 0.945})
    assert rep["marginals"]["favor_high_score=True"] == pytest.approx(
        {"port": 0.94, "jax": 0.95})
    assert rep["d"]["mean"] == pytest.approx((-0.01 + 0.01 - 0.02) / 3)


def test_report_on_the_committed_jsons(capsys):
    rep = paired_stats.report()
    for key in ("sched_ablation", "sched_ablation_unpaired"):
        r = rep[key]
        assert r["n"] == 40 and len(r["config_means"]["port"]) == 8, key
        assert r["ci95"][0] < r["mean"] < r["ci95"][1], key
        assert [g["n"] for g in r["by_jax_json"].values()] == [24, 16], key
    assert paired_stats.main([]) == 0
    out = capsys.readouterr().out
    assert "sched_ablation_unpaired: n 40," in out
    for key in ("mode_gap", "bf16_eval", "bracket_texture", "collapse_diag"):
        assert f"\n{key}:" in out
