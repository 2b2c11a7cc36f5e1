"""Dynamic patch-size (spatial context) scheduler — SURVEY.md C12, §3.4.

The port's own copy of dynseg/sched/scheduler.py (dynseg_torch imports nothing of the
JAX package); tests/test_torch_data.py holds it to the original.

THE core novelty of the reference: each training step the patch size
lambda is drawn from a distribution over the scheduled values
{25,...,65}; the distribution is updated from per-scale training feedback
(batch accuracy or loss). Re-expressed TPU-first: the scheduler is pure
host logic choosing WHICH pre-compiled static-shape step to run — the
device never sees a dynamic shape (SURVEY.md C12 TPU equivalent).

Distribution types ([R] dynamic.py:≈select_scale; flag distribution_type):
  * single_fixed  — always values[0]
  * multi_fixed   — deterministic cycle over values
  * uniform       — uniform random over values
  * multinomial   — sample proportional to normalized per-scale scores
  * multinomial_stratified — beyond-reference (round 3): DETERMINISTIC
    credit-based smooth weighted round-robin over the same score-derived
    probabilities.
    Built as a control for BENCHMARKS.md "uninformative-scales regime"
    finding 4 (the hypothesis that the iid sampler's VISITATION variance
    is what loses to cycling on long clean-label horizons): it keeps the
    reallocation ability (allocation tracks p with discrepancy < 1 step
    per scale at fixed p, and adapts to a score shift at the new rates
    within ~1/p steps — credits are bounded, no history effect) and
    removes the sampling noise entirely — with flat scores it reduces
    exactly to multi_fixed's round-robin.
    Measured outcome (finding 5): the hypothesis was REFUTED — within
    noise of both parents on the uninf set, and it does NOT inherit
    cycling's clean-horizon advantage (−7.9pp ± 10.5 paired, same
    collapse seeds as the iid multinomial). Ships with no accuracy
    claim; its value is exact, resumable, RNG-free scale allocation.

Score update ([R] dynamic.py:≈update scores in train loop): exponential
moving average of the chosen scale's batch accuracy or loss
(flag update_type). The exact reference rule is MED confidence
(SURVEY.md §3.4) so the sign convention is an explicit, bracketable knob:
`favor_high_score=True` samples well-performing contexts more often (the
paper's reading); False inverts to spend steps on struggling contexts.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from dynseg_torch.config import SchedulerConfig


class ScaleScheduler:
    """Host-side score-driven selection among bucketed patch sizes."""

    def __init__(self, cfg: SchedulerConfig, seed: int = 0):
        self.cfg = cfg
        self.values: List[int] = [int(v) for v in cfg.values]
        assert len(self.values) >= 1
        self.rng = np.random.default_rng(seed)
        # EMA score per scale; None until that scale has been visited.
        self._scores: Dict[int, Optional[float]] = {v: None for v in self.values}
        self._counts: Dict[int, int] = {v: 0 for v in self.values}
        self._cycle = 0
        # multinomial_stratified bookkeeping: per-scale credit for
        # smooth/dynamic weighted round-robin (credit_i += p_i(now) each
        # step; serve argmax; credit -= 1). Credits — NOT cumulative
        # "served vs fair share p_i*t" deficits: the deficit form applies
        # the CURRENT p retroactively to the whole run history, so a late
        # score shift would lock selection onto one scale for a stretch
        # proportional to all elapsed steps (review r3).
        self._credit: Dict[int, float] = {v: 0.0 for v in self.values}
        # Set by load_state_dict when the checkpoint's score SEMANTICS
        # (update_type / favor_high_score — they decide how scores map to
        # fitness) differ from the caller's cfg: {field: (ckpt, cli)}.
        self.semantics_adopted: Dict[str, tuple] = {}

    # ------------------------------------------------------------------ #
    # selection
    # ------------------------------------------------------------------ #
    def select(self) -> int:
        """Draw the patch size for the next step."""
        d = self.cfg.distribution_type
        if d == "single_fixed" or len(self.values) == 1:
            return self.values[0]
        if d == "multi_fixed":
            v = self.values[self._cycle % len(self.values)]
            self._cycle += 1
            return v
        if d == "uniform":
            return int(self.rng.choice(self.values))
        if d == "multinomial":
            return int(self.rng.choice(self.values, p=self.probabilities()))
        if d == "multinomial_stratified":
            return self._select_stratified()
        raise ValueError(f"unknown distribution_type: {d!r}")

    def _select_stratified(self) -> int:
        """Credit-based smooth weighted round-robin: every step each
        scale accrues credit equal to its CURRENT probability, the
        largest credit is served and pays 1. Deterministic; at FIXED p
        this telescopes to credit_i = p_i*t − served_i, so served counts
        never drift more than 1 step from exact proportionality, and
        with flat p the argmax tie-breaking yields plain round-robin in
        values order — i.e. multi_fixed is the degenerate case. Credits
        stay bounded (they sum to 0 invariantly), so when the live score
        table shifts, allocation adapts at the NEW rates within ~1/p
        steps — unlike the cumulative-deficit form, which reweights the
        whole history under the new p and can starve a scale for a
        stretch proportional to total elapsed steps (review r3)."""
        p = self.probabilities()
        for i, v in enumerate(self.values):
            self._credit[v] += p[i]
        carr = np.array([self._credit[v] for v in self.values])
        # Ties break to the LOWEST index, within an epsilon: float
        # accumulation noise (~1e-16/step) would otherwise permute the
        # flat-p round-robin order; genuine score differences move
        # credits by >=1e-3/step, far above the tolerance.
        best = int(np.argmax(carr >= carr.max() - 1e-9))
        v = self.values[best]
        self._credit[v] -= 1.0
        return v

    def probabilities(self) -> np.ndarray:
        """Current multinomial over scales (normalized fitness scores).

        Scales never visited get the mean fitness of visited ones (optimistic
        init) so every bucket is explored before the distribution sharpens.
        """
        fit = np.array(
            [self._fitness(v) for v in self.values], dtype=np.float64
        )
        # A diverged run can push a score to inf (loss overflow) — under
        # favor_high_score=False that makes fitness inf and inf/inf = NaN
        # probabilities, crashing rng.choice mid-run (review r2). Treat
        # non-finite fitness like unvisited: it gets the mean of the rest.
        fit = np.where(np.isfinite(fit), fit, np.nan)
        if np.all(np.isnan(fit)):
            return np.full(len(self.values), 1.0 / len(self.values))
        mean_fit = np.nanmean(fit)
        fit = np.where(np.isnan(fit), mean_fit, fit)
        # Normalize raw positive fitness (reference normalizes raw scores,
        # [R] dynamic.py:≈multinomial branch). All fitness definitions in
        # _fitness are non-negative; do NOT min-subtract — that collapses
        # the distribution and starves scales (a once-visited scale would
        # get p≈0 and never recover).
        fit = np.maximum(fit, 1e-6)
        t = max(self.cfg.temperature, 1e-6)
        if t != 1.0:
            fit = fit ** (1.0 / t)
        return fit / fit.sum()

    def _fitness(self, v: int) -> float:
        s = self._scores[v]
        if s is None:
            return float("nan")
        if self.cfg.update_type in ("acc", "balanced_acc"):
            # accuracy-like in [0,1]; higher is better
            return s if self.cfg.favor_high_score else (1.0 - s)
        # loss >= 0; lower is better
        return 1.0 / (1.0 + s) if self.cfg.favor_high_score else s

    # ------------------------------------------------------------------ #
    # feedback
    # ------------------------------------------------------------------ #
    def update(self, scale: int, loss: float, acc: float,
               bacc: Optional[float] = None) -> None:
        """EMA-update the chosen scale's score from this batch's feedback
        ([R] dynamic.py:≈scores[lambda] update; SURVEY.md §3.4). bacc is
        the imbalance-robust mean per-class recall (update_type
        balanced_acc — beyond-reference knob, round-1 verdict weak #5);
        falls back to plain accuracy when the caller has none."""
        if self.cfg.update_type == "balanced_acc":
            metric = acc if bacc is None else bacc
        else:
            metric = acc if self.cfg.update_type == "acc" else loss
        if not np.isfinite(metric):
            # Divergence feedback (inf/nan loss) must not poison the EMA
            # permanently — count the visit but keep the previous score.
            self._counts[scale] += 1
            return
        prev = self._scores[scale]
        ema = self.cfg.ema
        self._scores[scale] = (
            float(metric) if prev is None else ema * prev + (1.0 - ema) * float(metric)
        )
        self._counts[scale] += 1

    # ------------------------------------------------------------------ #
    # introspection / checkpointing
    # ------------------------------------------------------------------ #
    def state_dict(self) -> dict:
        return {
            "scores": {str(k): v for k, v in self._scores.items()},
            "counts": {str(k): v for k, v in self._counts.items()},
            "cycle": self._cycle,
            "credit": {str(k): v for k, v in self._credit.items()},
            "rng_state": self.rng.bit_generator.state,
            # Score-interpretation semantics: without them a restored
            # table can be ranked under the WRONG convention (e.g. a
            # loss-trained table read as accuracies flips best_scales).
            "update_type": self.cfg.update_type,
            "favor_high_score": self.cfg.favor_high_score,
        }

    def load_state_dict(self, state: dict) -> None:
        self._scores = {int(k): v for k, v in state["scores"].items()}
        self._counts = {int(k): int(v) for k, v in state["counts"].items()}
        # The restored table IS the training schedule: sync values so
        # summary()/probabilities()/best_scales() describe the checkpoint
        # even when the caller's --values differ (e.g. --operation info
        # with CLI defaults on a checkpoint trained with other scales).
        self.values = list(self._scores)
        self._cycle = int(state["cycle"])
        # Stratified WRR credits (pre-r3 checkpoints lack the key:
        # restart from zero credits — allocation re-converges to the
        # score table within len(values) steps, no schedule discontinuity
        # beyond that).
        credit = state.get("credit")
        self._credit = (
            {int(k): float(v) for k, v in credit.items()}
            if credit is not None
            else {v: 0.0 for v in self.values}
        )
        self.rng.bit_generator.state = state["rng_state"]
        # Adopt the checkpoint's score semantics for the same reason the
        # values are adopted: the TABLE defines what the scores mean.
        # Callers decide how loud to be (warn at inference, error on
        # --resume — cli.py). Pre-r2 checkpoints lack the keys: no-op.
        self.semantics_adopted = {}
        adopt = {}
        for field in ("update_type", "favor_high_score"):
            if field in state:
                ckpt_val = state[field]
                cli_val = getattr(self.cfg, field)
                if ckpt_val != cli_val:
                    self.semantics_adopted[field] = (ckpt_val, cli_val)
                    adopt[field] = ckpt_val
        if adopt:
            self.cfg = dataclasses.replace(self.cfg, **adopt)

    def summary(self) -> str:
        """One-line distribution state for the training printout
        (SURVEY.md C19: per-scale distribution logging)."""
        p = self.probabilities()
        parts = []
        for v, pi in zip(self.values, p):
            s = self._scores[v]
            parts.append(f"{v}:p={pi:.2f},s={'-' if s is None else f'{s:.3f}'}")
        return " ".join(parts)

    def best_scales(self, k: int = 3) -> List[int]:
        """Scales ranked by fitness — the paper uses the final distribution
        to pick inference scales (SURVEY.md C12)."""
        p = self.probabilities()
        order = np.argsort(-p)
        return [self.values[i] for i in order[:k]]
