"""Training engine (counterpart of dynseg/train.py).

One step: K2 gathers the batch on the device from the resident padded
tiles (positions and augment ids, a few KB, are the only host-to-device
traffic), the net runs forward and backward in train mode (Flax-exact
BatchNorm; with pool_backward="pallas" every pool's backward is K4), and
momentum SGD updates the params:

  * loss: per-pixel softmax cross-entropy averaged over the valid pixels;
  * optimizer: torch SGD, momentum with dampening 0, L2 weight decay on
    the 4-D conv kernels only (the head's included), the staircase
    exponential LR decay set from the step counter before each step; the
    same arithmetic as the reference's optax chain
    (add_decayed_weights -> sgd(momentum));
  * EMA of the params (ema_decay > 0): ema = d * ema + (1 - d) * p_new
    after each step, as the reference's track_ema.

PyTorch runs eagerly, so the reference's per-bucket jit becomes one
warm-up step per scale (`compile_buckets`: cuDNN picks its algorithms on
a shape's first call). The fp32 convolutions run without TF32, and every
convolution with cuDNN's deterministic algorithms, so that a seed gives
the same run, as the reference's does (tests/test_torch_determinism.py).

Data parallelism (`dynseg_torch.parallel`, one process per rank, as the
reference's jit over a 1-D mesh): the step is the single-device step on
the global batch. Every rank samples the global batch on the host with
the same seed and keeps its rows; the loss is the sum of its local CE
over the global count of valid pixels; BatchNorm takes the global
batch's statistics; the gradients are summed over the ranks in one flat
all-reduce before SGD adds the weight decay; loss, acc and bacc are the
global batch's. With shard_tiles every rank holds only its block of the
interleaved tiles and its rows carry local tile ids, sampled by the
reference's per-device samplers. eval_crops runs replicated, and only
rank 0 writes.

The device is always the caller's choice (`resolve_device`): asked for
"cuda" where no card is visible, the port raises and never carries on on
the CPU. `checkpoint_dict` / `load_checkpoint_dict` carry a TrainState to
and from what `dynseg_torch.checkpoint` writes.
"""

from __future__ import annotations

import collections
import copy
import dataclasses
import signal
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dynseg_torch import parallel
from dynseg_torch.bridge import flax_to_torch, init_variables_like_reference
from dynseg_torch.config import Config
from dynseg_torch.data.sampler import BalancedPatchSampler
from dynseg_torch.data.tiles import (IGNORE_LABEL, TileSet,
                                     fill_padded_context, mirror_pad,
                                     storage_dtype)
from dynseg_torch.metrics import (accuracy_counts, balanced_from_counts,
                                  batch_accuracy, confusion_matrix,
                                  recall_counts)
from dynseg_torch.models.dilated import build_model
from dynseg_torch.ops.gather import gather_batch
from dynseg_torch.sched.scheduler import ScaleScheduler
from dynseg_torch.utils.profiling import span

Metrics = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    """What the reference's TrainState holds: `model` carries the params
    and the BatchNorm running statistics, `optimizer` the momentum
    buffers, `ema` the params' EMA (None when ema_decay is 0)."""

    model: nn.Module
    optimizer: torch.optim.SGD
    step: int = 0
    ema: Optional[Dict[str, torch.Tensor]] = None


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; "cuda" where no card is visible raises
    instead of falling back to the CPU."""
    if device is None:
        raise ValueError("no device given: pass 'cuda' or 'cpu'")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' was asked for but no CUDA card is visible "
            "(torch.cuda.is_available() is false); pass --device cpu to run "
            "on the CPU")
    return dev


def learning_rate(cfg: Config, step: int) -> float:
    """optax.exponential_decay(staircase=True) at `step`, or the constant
    rate when lr_decay_rate >= 1."""
    t = cfg.train
    if t.lr_decay_rate < 1.0:
        return t.learning_rate * t.lr_decay_rate ** (step // t.lr_decay_steps)
    return t.learning_rate


def make_optimizer(cfg: Config, model: nn.Module) -> torch.optim.SGD:
    """Momentum SGD with L2 on the conv kernels (4-D weights) only; biases
    and BatchNorm scale/offset are not decayed."""
    kernels = [p for p in model.parameters() if p.dim() == 4]
    others = [p for p in model.parameters() if p.dim() != 4]
    return torch.optim.SGD(
        [{"params": kernels, "weight_decay": cfg.train.weight_decay},
         {"params": others, "weight_decay": 0.0}],
        lr=learning_rate(cfg, 0), momentum=cfg.train.momentum, dampening=0.0)


def _new_state(cfg: Config, model: nn.Module) -> TrainState:
    ema = None
    if cfg.train.ema_decay > 0.0:
        ema = {n: p.detach().clone() for n, p in model.named_parameters()}
    return TrainState(model, make_optimizer(cfg, model), 0, ema)


def init_state_template(cfg: Config, device) -> TrainState:
    """A TrainState with the shapes a checkpoint of `cfg` restores into,
    on `device`, with no trainer and no training tiles (the predict,
    testing and info paths); the values are torch's default init."""
    model = build_model(cfg.model, cfg.model.num_input_bands)
    model.to(resolve_device(device)).train()
    return _new_state(cfg, model)


def checkpoint_dict(state: TrainState) -> dict:
    """The TrainState as plain tensors on the CPU: the model's state_dict,
    the momentum buffers by parameter name (those the optimizer holds),
    the EMA dict or None, and the step."""
    def cpu(t):
        return t.detach().to("cpu", copy=True)

    momentum = {}
    for name, p in state.model.named_parameters():
        buf = state.optimizer.state.get(p, {}).get("momentum_buffer")
        if buf is not None:
            momentum[name] = cpu(buf)
    return {"model": {k: cpu(v) for k, v in state.model.state_dict().items()},
            "momentum": momentum,
            "ema": None if state.ema is None else {k: cpu(v) for k, v in state.ema.items()},
            "step": int(state.step)}


def load_checkpoint_dict(state: TrainState, ckpt: dict) -> TrainState:
    """Fill `state` (a template of the right shapes) from a
    `checkpoint_dict`, in place, on the template's device."""
    state.model.load_state_dict(ckpt["model"])
    params = dict(state.model.named_parameters())
    state.optimizer.state.clear()
    for name, buf in ckpt["momentum"].items():
        p = params[name]
        state.optimizer.state[p]["momentum_buffer"] = buf.to(p.device, p.dtype).clone()
    if (ckpt["ema"] is None) != (state.ema is None):
        raise ValueError(
            f"checkpoint has {'no ' if ckpt['ema'] is None else ''}EMA weights "
            f"but the template was built with ema_decay "
            f"{'> 0' if state.ema is not None else '= 0'}")
    if state.ema is not None:
        if set(ckpt["ema"]) != set(params):
            raise ValueError("EMA weights do not match the model's parameters")
        state.ema = {k: v.to(params[k].device, params[k].dtype).clone()
                     for k, v in ckpt["ema"].items()}
    state.step = int(ckpt["step"])
    return state


def ema_variables(cfg: Config, state: TrainState) -> Optional[Dict[str, torch.Tensor]]:
    """A state_dict with the EMA params and the live BatchNorm statistics,
    or None when EMA is off."""
    if state.ema is None or cfg.train.ema_decay <= 0.0:
        return None
    sd = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    sd.update({k: v.clone() for k, v in state.ema.items()})
    return sd


def _cross_entropy_terms(logits: torch.Tensor, labels: torch.Tensor):
    """(sum of the per-pixel softmax CE over the valid pixels, their
    count, int64)."""
    valid = (labels != IGNORE_LABEL).reshape(-1)
    safe = torch.where(valid, labels.reshape(-1), 0)
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), safe,
                         reduction="none")
    ce = torch.where(valid, ce, 0.0)
    return ce.sum(), valid.sum()


def masked_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean per-pixel softmax CE over the valid (non-IGNORE) pixels; 0 when
    no pixel is valid (F.cross_entropy with ignore_index gives NaN there)."""
    total, count = _cross_entropy_terms(logits, labels)
    return total / count.clamp(min=1)


def _index_tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host index array -> int32 tensor on `device`; to a card through
    pinned memory without a host sync."""
    t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def _mark(device: torch.device):
    """A point in the device's timeline: a recorded CUDA event on the card,
    the host clock on the CPU (where every op is synchronous)."""
    if device.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter()


def _elapsed_ms(start, end, block: bool) -> Optional[float]:
    """Milliseconds between two marks; None while `end` is still queued on
    the card and `block` is false."""
    if isinstance(start, float):
        return (end - start) * 1e3
    if block:
        end.synchronize()
    elif not end.query():
        return None
    return start.elapsed_time(end)


class Trainer:
    """Owns the resident tiles, the sampler, the per-scale batch sizes and
    the step; the model and optimizer live in the TrainState."""

    def __init__(self, cfg: Config, train_tiles: TileSet, device,
                 world: Optional[parallel.World] = None):
        self.world = parallel.world() if world is None else world
        n = self.world.size
        if cfg.train.num_devices != n:
            raise ValueError(
                f"num_devices {cfg.train.num_devices} but this process is one "
                f"of {n} rank(s): launch the ranks with dynseg_torch.parallel."
                f"spawn (python -m dynseg_torch --num_devices N)")
        self.shard_tiles = bool(cfg.train.shard_tiles) and n > 1
        # cuDNN runs float32 convs in TF32 by default; TF32 keeps ~3
        # decimal digits and would move the step away from the reference.
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        # The same seed gives the same run, as the reference's does: cuDNN
        # may otherwise pick backward algorithms that sum with atomics, and
        # the scheduler's draws turn that noise into another model. Every
        # rank of a group sets it when it builds its Trainer.
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        self.cfg = cfg
        self.device = resolve_device(device)
        self.scales = [int(v) for v in cfg.sched.values]
        self.pad = max(self.scales) // 2 + 1
        self.num_bands = int(train_tiles.images.shape[-1])

        # Fail before any large host work if the tiles cannot live on the
        # card even as uint8 (image C bytes + 1 label byte per pixel);
        # a quarter of the card is left for activations. Sharded tiles
        # divide the need across the ranks' cards.
        t, h, w, c = train_tiles.images.shape
        min_bytes = t * (h + 2 * self.pad) * (w + 2 * self.pad) * (c + 1)
        if self.device.type == "cuda":
            total = torch.cuda.get_device_properties(self.device).total_memory
            budget = 0.75 * total * (n if self.shard_tiles else 1)
            if min_bytes > budget:
                raise MemoryError(
                    f"tile set needs >= {min_bytes / 1e9:.1f} GB of device "
                    f"memory even at uint8 storage, more than 3/4 of the "
                    f"card's {total / 1e9:.1f} GB"
                    f"{f' x {n} ranks' if self.shard_tiles else ''}; shard it "
                    f"(--shard_tiles with a larger --num_devices) or train "
                    f"per region")

        # Mirror-pad once so a patch of any scheduled size centred on a
        # valid pixel stays inside; tiles smaller than the pack see their
        # own mirrored context. Masks stay IGNORE in the pad.
        with span("train.setup.pad") as pad:
            padded = fill_padded_context(mirror_pad(train_tiles, self.pad), self.pad)
        with span("train.setup.tables") as tables:
            sampler_kw = dict(num_classes=cfg.model.num_classes, pad=self.pad,
                              balanced=cfg.data.balanced_sampling,
                              max_positions_per_class=cfg.data.max_positions_per_class)
            if self.shard_tiles:
                padded, self.tile_order = self._interleave(padded, n)
                tpd = padded.images.shape[0] // n
                self.tiles_per_device = tpd
                # Every rank builds the n per-device samplers (seed + 31 d), so
                # that every rank draws the global batch in the reference's
                # order; it uploads only its own block of tiles.
                self.samplers = []
                for d in range(n):
                    shard = dataclasses.replace(
                        padded, images=padded.images[d * tpd:(d + 1) * tpd],
                        masks=padded.masks[d * tpd:(d + 1) * tpd])
                    try:
                        self.samplers.append(BalancedPatchSampler(
                            shard, seed=cfg.train.seed + 31 * d, **sampler_kw))
                    except ValueError as e:
                        raise ValueError(
                            f"--shard_tiles: device {d}'s tile shard has no "
                            f"labeled pixels; use more tiles or fewer devices") from e
                r = self.world.rank
                padded = dataclasses.replace(
                    padded, images=padded.images[r * tpd:(r + 1) * tpd],
                    masks=padded.masks[r * tpd:(r + 1) * tpd])
                self.sampler = self.samplers[0]  # the augment ids' source
            else:
                self.sampler = BalancedPatchSampler(padded, seed=cfg.train.seed,
                                                    **sampler_kw)
                self.samplers = [self.sampler]
        with span("train.setup.upload") as upload:
            self.images, self.masks, self.mean, self.std = self._upload(padded)
        # Host seconds of the set-up: mirror padding, the position tables,
        # and the upload (a blocking copy from pageable memory).
        self.setup_s = {"pad": pad.seconds, "tables": tables.seconds,
                        "upload": upload.seconds}
        self.dropout_gen = torch.Generator(device=self.device)
        self.dropout_gen.manual_seed(cfg.train.seed + 1)
        # (scale, patches, start mark, end mark) of the train_step calls not
        # yet folded into _step_sums, {scale: [calls, patches, ms]}.
        self.step_marks: collections.deque = collections.deque()
        self._step_sums: Dict[int, List[float]] = {}

    @staticmethod
    def _interleave(padded: TileSet, n: int) -> Tuple[TileSet, np.ndarray]:
        """The reference's shard layout: all-IGNORE dummy tiles pad the set
        to a multiple of n, then the tiles are interleaved so that block d
        holds tiles {d, d+n, ...} and the dummies spread over the blocks.
        Returns the laid-out set and, per laid-out tile, its index in the
        given set (>= its length for a dummy)."""
        images, masks = padded.images, padded.masks
        t_pad = (-images.shape[0]) % n
        if not t_pad:
            return padded, np.arange(images.shape[0])
        images = np.concatenate(
            [images, np.zeros((t_pad,) + images.shape[1:], images.dtype)])
        masks = np.concatenate(
            [masks, np.full((t_pad,) + masks.shape[1:], IGNORE_LABEL, masks.dtype)])
        total = images.shape[0]
        order = np.concatenate([np.arange(d, total, n) for d in range(n)])
        return (dataclasses.replace(padded, images=images[order], masks=masks[order]),
                order)

    def unsharded_positions(self, pos: np.ndarray) -> np.ndarray:
        """Global positions (B, 3) with the tile ids of the unsharded set:
        under shard_tiles, rank d's rows carry ids local to block d."""
        if not self.shard_tiles:
            return pos
        out = pos.copy()
        bl = len(pos) // self.world.size
        for d in range(self.world.size):
            ids = pos[d * bl:(d + 1) * bl, 0] + d * self.tiles_per_device
            out[d * bl:(d + 1) * bl, 0] = self.tile_order[ids]
        return out

    def _upload(self, padded: TileSet):
        sd = storage_dtype(padded.images)
        dev = self.device
        return (torch.from_numpy(np.ascontiguousarray(padded.images.astype(sd))).to(dev),
                torch.from_numpy(np.ascontiguousarray(padded.masks.astype(np.uint8))).to(dev),
                torch.as_tensor(padded.mean, dtype=torch.float32, device=dev),
                torch.as_tensor(padded.std, dtype=torch.float32, device=dev))

    # ------------------------------------------------------------------ #
    def init_state(self, seed: int = 0, variables: Optional[dict] = None) -> TrainState:
        """A fresh TrainState from a Flax-shaped variables tree (numpy
        leaves; default: `init_variables_like_reference` at `seed`, the
        weights the reference's `init_state(jax.random.key(seed))` starts
        from)."""
        if variables is None:
            variables = init_variables_like_reference(self.cfg.model, self.num_bands, seed)
        model = build_model(self.cfg.model, self.num_bands)
        model.load_state_dict(flax_to_torch(variables))
        model.to(self.device).train()
        return _new_state(self.cfg, model)

    def reseed_samplers(self, salt: int) -> None:
        """Resume support: fold the restart iteration into every sampler's
        position stream (BalancedPatchSampler.reseed), as the reference."""
        for s in self.samplers:
            s.reseed(salt)

    def _step_impl(self, state: TrainState, positions: torch.Tensor,
                   aug_ids: torch.Tensor, size: int,
                   generator: Optional[torch.Generator] = None) -> Metrics:
        """One optimizer step on the batch at `positions`; metrics stay on
        the device."""
        imgs, labs = gather_batch(self.images, self.masks, self.mean, self.std,
                                  positions, aug_ids, size)
        model, opt = state.model, state.optimizer
        model.train()
        logits = model(imgs, self.dropout_gen if generator is None else generator)
        # This rank's CE over the global batch's valid pixels: the ranks'
        # losses and gradients sum to the global batch's.
        ce_sum, valid = _cross_entropy_terms(logits, labs)
        valid = parallel.all_reduce_(valid)
        loss = ce_sum / valid.clamp(min=1)
        for group in opt.param_groups:
            group["lr"] = learning_rate(self.cfg, state.step)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        parallel.all_reduce_grads(model.parameters())
        opt.step()
        state.step += 1
        if state.ema is not None:
            d = self.cfg.train.ema_decay
            with torch.no_grad():
                for name, p in model.named_parameters():
                    state.ema[name].mul_(d).add_(p, alpha=1.0 - d)
        logits = logits.detach()
        bacc = self.cfg.sched.update_type == "balanced_acc"
        # The global batch's metrics from one all-reduce of the sums; the
        # counts (exact in float64) go back to int64, so that the ratios
        # are those of batch_accuracy and balanced_batch_accuracy.
        nc = self.cfg.model.num_classes
        parts = [loss.detach().reshape(1), accuracy_counts(logits, labs)[0].reshape(1)]
        if bacc:
            parts += list(recall_counts(logits, labs, nc))
        sums = parallel.all_reduce_(torch.cat([p.double() for p in parts]))
        counts = sums[1:].long()
        metrics = {"loss": sums[0].float(),
                   "acc": (counts[0] / valid.clamp(min=1)).float()}
        if bacc:
            metrics["bacc"] = balanced_from_counts(counts[1:1 + nc], counts[1 + nc:])
        return metrics

    def _chunk_impl(self, state: TrainState, positions: torch.Tensor,
                    aug_ids: torch.Tensor, size: int,
                    generator: Optional[torch.Generator] = None) -> Metrics:
        """K = positions.shape[0] steps; returns the chunk means."""
        ms = [self._step_impl(state, positions[i], aug_ids[i], size, generator)
              for i in range(positions.shape[0])]
        if len(ms) == 1:
            return ms[0]
        return {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}

    # ------------------------------------------------------------------ #
    def batch_size_for(self, size: int) -> int:
        """Global per-step batch of a bucket; with rescale_batch_by_area the
        pixel count stays about constant across scales. Rounded to a
        multiple of the ranks, at least one row each."""
        b = self.cfg.train.batch_size
        if self.cfg.train.rescale_batch_by_area:
            b = max(8, round(b * (self.scales[0] / size) ** 2))
        n = self.world.size
        return max(n, (b // n) * n)

    def global_batch_inputs(self, size: int, augment: Optional[bool] = None,
                            k: int = 1) -> Tuple[np.ndarray, np.ndarray]:
        """Host sampling of K global step-batches, as the reference draws
        them: (K, B, 3) positions and (K, B) augment ids, int32 numpy.
        With shard_tiles, rank d's rows come from sampler d and carry
        local tile ids; the augment ids from sampler 0."""
        b = self.batch_size_for(size)
        aug = self.cfg.data.augment if augment is None else augment
        if self.shard_tiles:
            bl = b // self.world.size
            pos = np.empty((k, b, 3), np.int32)
            for d, s in enumerate(self.samplers):
                pos[:, d * bl:(d + 1) * bl] = s.sample(k * bl).reshape(k, bl, 3)
        else:
            pos = self.sampler.sample(k * b).reshape(k, b, 3)
        aug_ids = self.sampler.sample_augment_ids(k * b, aug).reshape(k, b)
        return pos, aug_ids

    def local_rows(self, b: int) -> slice:
        """This rank's rows of a global batch of b."""
        n, r = self.world.size, self.world.rank
        return slice(r * (b // n), (r + 1) * (b // n))

    def make_batch_inputs(self, size: int, augment: Optional[bool] = None,
                          k: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
        """This rank's rows of K global step-batches (`global_batch_inputs`):
        (K, B/n, 3) positions and (K, B/n) augment ids, int32 on the
        device."""
        pos, aug_ids = self.global_batch_inputs(size, augment, k)
        mine = self.local_rows(pos.shape[1])
        return (_index_tensor(pos[:, mine], self.device),
                _index_tensor(aug_ids[:, mine], self.device))

    def train_step(self, state: TrainState, size: int) -> Tuple[TrainState, Metrics]:
        """cfg.train.steps_per_call optimizer steps at patch size `size`."""
        k = self.cfg.train.steps_per_call
        with span("train.sample"):
            pos, aug = self.make_batch_inputs(size, k=k)
        with span("train.step"):
            start = _mark(self.device)
            metrics = self._chunk_impl(state, pos, aug, size)
            self.step_marks.append((size, k * self.batch_size_for(size), start,
                                    _mark(self.device)))
            self._fold_marks(block=False)
        return state, metrics

    def _fold_marks(self, block: bool) -> None:
        """Fold the marks of finished train_step calls into the per-scale
        sums, oldest first, so a long run holds only the marks in flight."""
        while self.step_marks:
            size, patches, start, end = self.step_marks[0]
            ms = _elapsed_ms(start, end, block)
            if ms is None:
                return
            self.step_marks.popleft()
            s = self._step_sums.setdefault(size, [0, 0, 0.0])
            s[0] += 1
            s[1] += patches
            s[2] += ms

    def step_stats(self) -> Dict[int, dict]:
        """Per scale, over every train_step call so far: steps, mean ms per
        step on the device's timeline (CUDA events around the step's
        launches; the host clock on the CPU), and patches/s."""
        self._fold_marks(block=True)
        k = self.cfg.train.steps_per_call
        return {size: {"steps": calls * k, "ms_per_step": ms / (calls * k),
                       "patches_per_s": patches / (ms / 1e3)}
                for size, (calls, patches, ms) in sorted(self._step_sums.items())}

    def eval_crops(self, state: TrainState, tiles_dev, positions: np.ndarray,
                   size: int) -> Metrics:
        """Crop validation of the raw iterate on a resident tile set (eval
        BatchNorm, no augment): loss, acc and the confusion matrix."""
        images, masks, mean, std = tiles_dev
        pos = _index_tensor(positions, self.device)
        aug = torch.zeros(pos.shape[0], dtype=torch.int32, device=self.device)
        imgs, labs = gather_batch(images, masks, mean, std, pos, aug, size)
        model = state.model
        model.eval()
        try:
            with torch.inference_mode():
                logits = model(imgs)
                return {"loss": masked_cross_entropy(logits, labs),
                        "acc": batch_accuracy(logits, labs),
                        "confusion": confusion_matrix(
                            logits.argmax(-1), labs, self.cfg.model.num_classes)}
        finally:
            model.train()

    def put_tiles(self, tiles: TileSet, pad: Optional[int] = None):
        """Mirror-pad a tile set and put it on the device for eval_crops."""
        p = self.pad if pad is None else pad
        padded = fill_padded_context(mirror_pad(tiles, p), p)
        return self._upload(padded), padded

    def recalibrate_batch_stats(self, variables: Dict[str, torch.Tensor],
                                n_batches: int, start: int = 0) -> Dict[str, torch.Tensor]:
        """Recompute the BatchNorm running statistics for the weights in
        `variables` (a state_dict on the device): n_batches train-mode
        forwards, params frozen, over freshly sampled batches cycling the
        trained scales from the one at index `start` (a caller that goes
        on from an earlier call's statistics passes the forwards made so
        far). Returns the state_dict with the new statistics, or
        `variables` itself when n_batches <= 0."""
        if n_batches <= 0:
            return variables
        model = build_model(self.cfg.model, self.num_bands).to(self.device)
        model.load_state_dict(variables)
        model.train()
        gen = torch.Generator(device=self.device)
        gen.manual_seed(0)
        with torch.no_grad():
            for i in range(n_batches):
                scale = self.scales[(start + i) % len(self.scales)]
                pos, aug = self.make_batch_inputs(scale)
                imgs, _ = gather_batch(self.images, self.masks, self.mean,
                                       self.std, pos[0], aug[0], scale)
                model(imgs, gen)
        return {k: v.detach().clone() for k, v in model.state_dict().items()}

    def compile_buckets(self, state: TrainState) -> Dict[int, float]:
        """One warm-up step per scale on a deep copy of the state (the
        caller's params, momentum, EMA, sampler and dropout stream are
        untouched), so the timed loop never meets a first-call shape.
        Returns seconds per scale."""
        times: Dict[int, float] = {}
        k = self.cfg.train.steps_per_call
        gen = torch.Generator(device=self.device)
        gen.manual_seed(0)
        for s in self.scales:
            t0 = time.perf_counter()
            b = self.batch_size_for(s) // self.world.size
            pos = np.zeros((k, b, 3), np.int32)
            pos[..., 1:] = self.pad
            scratch = copy.deepcopy(state)
            metrics = self._chunk_impl(
                scratch, _index_tensor(pos, self.device),
                _index_tensor(np.zeros((k, b), np.int32), self.device), s, gen)
            float(metrics["loss"])
            times[s] = time.perf_counter() - t0
            del scratch
        return times


def train_loop(
    cfg: Config,
    trainer: Trainer,
    state: TrainState,
    scheduler: ScaleScheduler,
    niter: Optional[int] = None,
    log_every: int = 50,
    on_eval=None,
    log=print,
    start_iter: int = 0,
    checkpointer=None,
) -> TrainState:
    """The reference's hot loop: select a scale -> gather + step on the
    device -> update the scheduler's scores -> periodic validation and
    checkpoint.

    Scheduler metrics are copied to the host without blocking and read
    `metric_fetch_depth` launches later, so the host queues the next step
    while the card runs this one. With a checkpointer, SIGTERM/SIGINT set
    a flag checked once per launch: the loop drains the pending scores,
    checkpoints the exact iteration and returns.

    Under a data-parallel group every rank runs this loop in step: the stop
    (a signal to any rank) and the scale (rank 0's choice, which every
    rank's scheduler must also have drawn) are agreed on the host before
    each launch, so all ranks take the same scale and stop at the same
    step boundary."""
    niter = cfg.train.niter if niter is None else niter
    stop_sig = {"num": None}
    prev_handlers = {}
    if checkpointer is not None:
        def _on_signal(signum, frame):
            stop_sig["num"] = signum

        for s in (signal.SIGTERM, signal.SIGINT):
            try:
                prev_handlers[s] = signal.signal(s, _on_signal)
            except ValueError:  # not the main thread (tests, embedders)
                pass
    k = cfg.train.steps_per_call
    depth = max(1, cfg.train.metric_fetch_depth)
    if start_iter:
        # A resumed run takes a distinct dropout stream, as the
        # reference's fold_in(start_iter).
        trainer.dropout_gen.manual_seed(int(np.random.SeedSequence(
            (cfg.train.seed + 1, start_iter)).generate_state(1)[0]))
    pending = collections.deque()  # (scale, host metrics, copy event)

    def fetch_async(metrics: Metrics):
        host = {key: v.detach().to("cpu", non_blocking=True)
                for key, v in metrics.items()}
        event = None
        if trainer.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        return host, event

    def consume_one():
        ps, host, event = pending.popleft()
        if event is not None:
            with span("train.metric_wait"):
                event.synchronize()
        with span("train.update"):
            scheduler.update(ps, float(host["loss"]), float(host["acc"]),
                             bacc=float(host["bacc"]) if "bacc" in host else None)

    with span("train.loop"):
        t0 = time.perf_counter()
        patches = 0
        it = start_iter
        try:
            while it < niter:
                stop, _ = parallel.agree(stop_sig["num"] is not None)
                if stop:
                    while pending:
                        consume_one()
                    checkpointer(it, state, scheduler)
                    log(f"signal {stop_sig['num'] or 'to another rank'} received: "
                        f"checkpointed at iteration {it}, stopping")
                    return state
                with span("train.select"):
                    scale = scheduler.select()
                    chosen = parallel.broadcast_choice(scale)
                if chosen != scale:
                    raise RuntimeError(
                        f"rank {parallel.world().rank}: the scheduler drew scale "
                        f"{scale} where rank 0's drew {chosen}; the ranks' "
                        f"schedulers diverged")
                state, metrics = trainer.train_step(state, scale)
                prev_it, it = it, it + k
                patches += k * trainer.batch_size_for(scale)
                pending.append((scale, *fetch_async(metrics)))
                while len(pending) > depth:
                    consume_one()

                def crossed(every: int) -> bool:
                    if every <= 0:  # 0 disables a periodic action
                        return False
                    return prev_it // every != it // every

                if crossed(log_every):
                    m = {key: float(v) for key, v in metrics.items()}
                    dt = time.perf_counter() - t0
                    log(f"iter {it}/{niter} scale={scale} loss={m['loss']:.4f} "
                        f"acc={m['acc']:.4f} patches/s={patches / max(dt, 1e-9):.1f} "
                        f"| {scheduler.summary()}")
                    t0 = time.perf_counter()
                    patches = 0
                if on_eval is not None and crossed(cfg.train.eval_every):
                    # Drain first: the scores must reflect every completed batch.
                    while pending:
                        consume_one()
                    on_eval(it, state)
                if checkpointer is not None and crossed(cfg.train.checkpoint_every):
                    while pending:
                        consume_one()
                    checkpointer(it, state, scheduler)
            while pending:
                consume_one()
            return state
        finally:
            for s, h in prev_handlers.items():
                signal.signal(s, h)
