"""Full-tile inference: multi-scale window voting and dense blockwise
prediction (counterpart of dynseg/infer.py).

Window mode slides lambda x lambda windows at stride ~lambda/2 over each
mirror-padded tile for every scale, sums softmax probabilities over
overlaps and scales, and argmaxes. The uniform-stride bulk of each
scale's windows is placed with one `F.fold` (the overlap-add the
reference's grid-fold builds by hand); the few origins clamped to the
buffer edge are added one by one. A scale whose collected probabilities
would pass DYNSEG_FOLD_MEM_GB (default 2.0, the reference's cap and
estimate) is folded in bands of origin rows, each band's buffer under the
cap. Dense mode runs one forward per pixel:
blocks with a halo of at least the receptive radius reproduce the
whole-tile forward, and their centres overwrite the map.

Test-time augmentation (cfg.infer.tta, or a predict method's `tta`) runs
either mode on the 8 dihedral transforms of a tile's own padded crop,
maps each probability map back and argmaxes their mean.

The packed tile set stays resident on the device while it fits
cfg.infer.hbm_budget_gb; past it, it stays on the host and each predict
uploads its one padded tile (`_tile`). Tiles, probability and label maps
keep the reference's NHWC layout and dtypes. The device is the caller's
(`train.resolve_device`).

Under a data-parallel group (`dynseg_torch.parallel`, the reference's
mesh) the forwards split across the ranks: a window batch holds a
multiple of n windows and each rank forwards its B/n of them; dense mode
groups n x block_batch blocks and each rank forwards block_batch. As in
the reference, with one device too, a short last batch or group is
padded to that size. The probabilities are gathered exactly
(`parallel.gather_rows`), and the overlap-add or overwrite then runs
unchanged on every rank, as the reference's runs replicated. int8 calibration is replicated too, so the
quantized state_dict is the single-device one on every rank. Only rank 0
logs in `validate_test`.
"""

from __future__ import annotations

import os
import time
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from dynseg_torch import parallel
from dynseg_torch.config import Config
from dynseg_torch.data.tiles import (TileSet, fill_padded_context,
                                     mirror_pad, storage_dtype)
from dynseg_torch.metrics import (confusion_matrix, erode_boundaries,
                                  scores_from_confusion)
from dynseg_torch.models.dilated import build_model, receptive_radius
from dynseg_torch.ops import quant as quant_ops
from dynseg_torch.ops.dihedral import dihedral, dihedral_inv
from dynseg_torch.train import resolve_device


def window_origins(lo: int, hi: int, size: int, stride: int, lim: int) -> List[int]:
    """1-D window origins r (0 <= r <= lim) whose [r, r+size) union covers
    [lo, hi). Origins start size//2 before `lo` (mirror context for edge
    pixels) and a final window snapped to `lim` covers the right edge."""
    if not (hi > lo and lim >= 0 and size >= 1):
        raise ValueError(f"bad window range lo={lo} hi={hi} size={size} lim={lim}")
    first = min(max(0, lo - size // 2), lim)
    origins = list(range(first, min(hi, lim + 1), stride))
    while origins[-1] + size < hi and origins[-1] < lim:
        origins.append(min(lim, origins[-1] + stride))
    if origins[-1] + size < hi:
        raise ValueError("window cannot cover range")
    out = [r for r in origins if r < hi]
    return out or [min(lim, max(0, lo))]


def _split_uniform(xs: Sequence[int], stride: int) -> Tuple[List[int], List[int]]:
    """Longest uniform-`stride` prefix of window origins, and the tail."""
    n = 1
    while n < len(xs) and xs[n] - xs[n - 1] == stride:
        n += 1
    return list(xs[:n]), list(xs[n:])


class Inferencer:
    """Multi-scale overlap-add and dense predictor over a padded TileSet
    held on `device`. Predict methods take the port's state_dict
    (`bridge.flax_to_torch`) on the same device."""

    def __init__(self, cfg: Config, tiles: TileSet, device,
                 world: Optional[parallel.World] = None):
        # cuDNN runs float32 convs in TF32 by default; TF32 keeps ~3
        # decimal digits and would move the calibrated activation ranges
        # and the probabilities away from the float32 reference.
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        self.cfg = cfg
        self.device = resolve_device(device)
        self.world = parallel.world() if world is None else world
        self.model = build_model(cfg.model, tiles.num_bands).to(self.device)
        self._apply = self._float_apply
        self.scales = [int(s) for s in cfg.infer.scales]
        # The pad covers both the window context and the dense halo.
        self.pad = max(max(self.scales), cfg.infer.dense_halo)
        self.nc = cfg.model.num_classes
        # Bytes of the largest tensor collected for a window fold in the
        # last window-mode call (`_window_device`).
        self.fold_peak_bytes = 0
        self.set_tiles(tiles)

    def _float_apply(self, variables, x):
        return torch.func.functional_call(self.model, variables, (x,))

    def set_tiles(self, tiles: TileSet) -> None:
        """Bind a tile set: mirror-pad every tile with its own reflected
        context and store it as uint8 where lossless. A packed set within
        cfg.infer.hbm_budget_gb (GiB) is uploaded whole; a larger one
        stays on the host as numpy, and `_tile` uploads one tile a
        predict, so the device holds one padded tile at a time."""
        padded = fill_padded_context(
            mirror_pad(tiles, self.pad, pad_masks=False), self.pad)
        self.valid_hw = np.asarray(tiles.valid_hw)
        self.padded_hw = tuple(int(v) for v in padded.images.shape[1:3])
        packed = padded.images.astype(storage_dtype(padded.images), copy=False)
        del padded
        self._stream = packed.nbytes > int(self.cfg.infer.hbm_budget_gb * 1024**3)
        self.images = packed if self._stream else torch.from_numpy(packed).to(self.device)
        self.mean = torch.as_tensor(tiles.mean, dtype=torch.float32,
                                    device=self.device)
        self.std = torch.as_tensor(tiles.std, dtype=torch.float32,
                                   device=self.device)

    @torch.inference_mode()
    def enable_quant(self, variables):
        """With cfg.infer.quant == "int8": calibrate activation ranges on
        sample crops of the bound tiles (the reference's crops: seed 0,
        side min(128, h, w)), quantize the state_dict, switch this
        Inferencer to the mixed forward and return the quantized
        state_dict. With "none", return `variables` unchanged."""
        icfg = self.cfg.infer
        if icfg.quant == "none":
            return variables
        rng = np.random.default_rng(0)
        num_tiles = int(self.valid_hw.shape[0])
        crops = []
        for i in range(int(icfg.quant_calib_crops)):
            t = i % num_tiles
            h, w = (int(v) for v in self.valid_hw[t])
            s = min(128, h, w)
            y0 = self.pad + int(rng.integers(0, max(1, h - s + 1)))
            x0 = self.pad + int(rng.integers(0, max(1, w - s + 1)))
            crop = self._tile(t)[y0:y0 + s, x0:x0 + s].float()
            crops.append((crop - self.mean) / self.std)
        ranges = quant_ops.calibrate(
            self.cfg.model, variables, crops, icfg.quant_calib_pct)
        qvars = quant_ops.quantize_variables(
            self.cfg.model, variables, ranges,
            num_input_bands=int(self.images.shape[-1]),
            min_ch=icfg.quant_min_ch, exit_int8=icfg.quant_exit)
        self._apply = quant_ops.make_apply(self.cfg.model)
        return qvars

    def _tile(self, tile_idx: int) -> torch.Tensor:
        """One padded tile on the device: uploaded from the host set when
        streaming, else a view of the resident set."""
        if self._stream:
            return torch.from_numpy(self.images[tile_idx]).to(self.device)
        return self.images[tile_idx]

    def _probs(self, variables, tile: torch.Tensor, origins: np.ndarray,
               size: int) -> torch.Tensor:
        """Softmax probabilities (N, size, size, nc) of the normalized
        size x size crops of `tile` at `origins` (N, 2)."""
        o = torch.as_tensor(origins, dtype=torch.long, device=self.device)
        ar = torch.arange(size, device=self.device)
        rows = (o[:, 0, None] + ar)[:, :, None]
        cols = (o[:, 1, None] + ar)[:, None, :]
        x = (tile[rows, cols].float() - self.mean) / self.std
        return torch.softmax(self._apply(variables, x).float(), dim=-1)

    def _window_batch(self) -> int:
        """Windows per forward batch: window_batch, rounded to a multiple of
        the ranks under a group (at least one window each)."""
        b, n = int(self.cfg.infer.window_batch), self.world.size
        return max(n, b // n * n)

    def _split_probs(self, variables, tile: torch.Tensor, origins: np.ndarray,
                     size: int, full: int) -> torch.Tensor:
        """`_probs` of `origins`: the origins are padded to `full` (a
        multiple of the ranks, at least len(origins)) with copies of the
        last, as the reference pads a batch to its fixed size, so that every
        forward of a scale has one batch size; under a group each rank
        forwards its equal slice, and every rank gets all the
        probabilities, bitwise (`parallel.gather_rows`)."""
        m = len(origins)
        padded = np.concatenate([origins, np.repeat(origins[-1:], full - m, 0)])
        bl = full // self.world.size
        r = self.world.rank
        local = self._probs(variables, tile, padded[r * bl:(r + 1) * bl], size)
        return parallel.gather_rows(local)[:m]

    def _source(self, tile_idx: int, override):
        """(device tile, h, w, Hp, Wp): the padded tile to predict, its
        valid extent and its padded extent."""
        if override is None:
            h, w = (int(x) for x in self.valid_hw[tile_idx])
            return (self._tile(tile_idx), h, w) + self.padded_hw
        tile, h, w = override
        return (tile, int(h), int(w)) + tuple(int(x) for x in tile.shape[:2])

    def _collected(self, t: torch.Tensor) -> None:
        self.fold_peak_bytes = max(self.fold_peak_bytes, t.numel() * t.element_size())

    def _fold(self, variables, tile, prob, cnt, s: int, stride: int,
              rows_u: Sequence[int], cols_u: Sequence[int],
              tails: Sequence[Tuple[int, int]]) -> None:
        """Add the windows rows_u x cols_u (a uniform-stride grid) to prob
        and cnt with one `F.fold`, then `tails` one by one."""
        B = self._window_batch()
        bulk = [(r, c) for r in rows_u for c in cols_u]
        origins = np.array(bulk + list(tails), np.int64).reshape(-1, 2)
        probs = torch.cat([
            self._split_probs(variables, tile, origins[i:i + B], s, B)
            for i in range(0, len(origins), B)])
        self._collected(probs)
        nbu = len(bulk)
        if nbu:
            R = (len(rows_u) - 1) * stride + s
            C = (len(cols_u) - 1) * stride + s
            cols_in = probs[:nbu].permute(3, 1, 2, 0).reshape(
                1, self.nc * s * s, nbu)
            self._collected(cols_in)
            placed = F.fold(cols_in, (R, C), s, stride=stride)[0]
            ones = torch.ones((1, s * s, nbu), device=self.device)
            votes = F.fold(ones, (R, C), s, stride=stride)[0, 0]
            r0, c0 = rows_u[0], cols_u[0]
            prob[r0:r0 + R, c0:c0 + C] += placed.permute(1, 2, 0)
            cnt[r0:r0 + R, c0:c0 + C] += votes
        for (r, c), p in zip(tails, probs[nbu:]):
            prob[r:r + s, c:c + s] += p
            cnt[r:r + s, c:c + s] += 1.0

    # ------------------------------------------------------------------ #
    @torch.inference_mode()
    def _window_device(self, variables, tile_idx: int,
                       scales: Optional[Sequence[int]] = None, override=None):
        """Window voting left on the device: (pred uint8, summed probs,
        vote counts), all in valid coordinates. `fold_peak_bytes` is then
        the size of the largest tensor collected for a fold (a scale's or a
        band's probabilities, or their permuted copy). override=(tile, h,
        w) predicts that padded device tile, whose valid block is
        [pad:pad+h, pad:pad+w], instead of tile `tile_idx` (TTA)."""
        scales = [int(s) for s in (scales or self.scales)]
        tile, h, w, Hp, Wp = self._source(tile_idx, override)
        prob = torch.zeros((Hp, Wp, self.nc), dtype=torch.float32,
                           device=self.device)
        cnt = torch.zeros((Hp, Wp), dtype=torch.float32, device=self.device)
        B = self._window_batch()
        cap = float(os.environ.get("DYNSEG_FOLD_MEM_GB", "2.0")) * 1e9
        self.fold_peak_bytes = 0
        for s in scales:
            # Clamped to the window size: a larger stride leaves holes.
            stride = min(s, max(1, int(round(s * self.cfg.infer.stride_fraction))))
            rows = window_origins(self.pad, self.pad + h, s, stride, Hp - s)
            cols = window_origins(self.pad, self.pad + w, s, stride, Wp - s)
            rows_u, rows_t = _split_uniform(rows, stride)
            cols_u, cols_t = _split_uniform(cols, stride)
            tails = ([(r, c) for r in rows_u for c in cols_t]
                     + [(r, c) for r in rows_t for c in cols])
            per_window = s * s * self.nc * 4
            n = len(rows) * len(cols)
            # Windows a band may collect: all of them where the reference's
            # estimate of the scale's buffer (dynseg/infer.py `_use_fold`:
            # whole window batches of every window) is within the cap, else
            # as many whole window batches as the cap holds, at least one.
            if -(-n // B) * B * per_window <= cap:
                per_band = n
            else:
                per_band = max(1, int(cap // per_window) // B) * B
            # Bands of whole origin rows; the tails fill the last band's
            # room, and any left over go in bands of their own.
            nr = max(1, per_band // len(cols_u))
            i = t = 0
            while i < len(rows_u) or t < len(tails):
                band = rows_u[i:i + nr]
                i += len(band)
                room = (max(0, per_band - len(band) * len(cols_u))
                        if i == len(rows_u) else 0)
                self._fold(variables, tile, prob, cnt, s, stride, band, cols_u,
                           tails[t:t + room])
                t += room
        p = self.pad
        valid = prob[p:p + h, p:p + w]
        pred = torch.argmax(valid, dim=-1).to(torch.uint8)
        return pred, valid, cnt[p:p + h, p:p + w]

    @torch.inference_mode()
    def _dense_device(self, variables, tile_idx: int, block: int, halo: int,
                      override=None):
        """Dense prediction left on the device: (pred uint8, probs, None).
        `override` as in `_window_device`. The block clamps to the valid
        extent with no floor, so that the halo'd block of a sliver tile
        stays inside its padded extent."""
        tile, h, w, Hp, Wp = self._source(tile_idx, override)
        block_eff = max(1, min(block, Hp - 2 * self.pad, Wp - 2 * self.pad))

        def starts_1d(extent: int) -> List[int]:
            ss = list(range(self.pad,
                            self.pad + max(1, extent - block_eff + 1), block_eff))
            if ss[-1] + block_eff < self.pad + extent:
                ss.append(self.pad + extent - block_eff)
            return ss

        starts = np.array(
            [(r, c) for r in starts_1d(h) for c in starts_1d(w)], np.int64)
        # Groups of D = n x block_batch blocks (the reference's auto batch:
        # 8 a rank where the tile has 8 blocks a rank, else an even share);
        # each rank forwards block_batch of them.
        n = self.world.size
        bb = int(self.cfg.infer.dense_block_batch)
        if bb <= 0:
            bb = 8 if len(starts) >= 8 * n else max(1, -(-len(starts) // n))
        D = n * bb
        ext = block_eff + 2 * halo
        prob = torch.zeros((Hp, Wp, self.nc), dtype=torch.float32,
                           device=self.device)
        for lo in range(0, len(starts), D):
            group = starts[lo:lo + D]
            probs = self._split_probs(variables, tile, group - halo, ext, D)
            centers = probs[:, halo:halo + block_eff, halo:halo + block_eff]
            # Overlapping blocks recompute the same values: overwrite.
            for (r, c), p in zip(group, centers):
                prob[r:r + block_eff, c:c + block_eff] = p
        p = self.pad
        valid = prob[p:p + h, p:p + w]
        return torch.argmax(valid, dim=-1).to(torch.uint8), valid, None

    def _check_halo(self, halo: int) -> None:
        rad = receptive_radius(self.cfg.model)
        if halo < rad:
            warnings.warn(
                f"dense_halo {halo} < receptive radius {rad} of "
                f"{self.cfg.model.net_type}: block-border pixels are "
                f"approximate (pass --dense_halo {rad} for exactness)",
                RuntimeWarning, stacklevel=3)
        if halo > self.pad:
            raise ValueError(
                f"dense halo {halo} exceeds the tile mirror pad {self.pad}")

    def predict_tile_device(self, variables, tile_idx: int,
                            scales: Optional[Sequence[int]] = None,
                            tta: Optional[bool] = None) -> torch.Tensor:
        """One tile's uint8 label map, per cfg.infer.mode, on the device;
        with tta (default cfg.infer.tta) the 8-way dihedral fusion."""
        icfg = self.cfg.infer
        if icfg.mode == "dense":
            self._check_halo(icfg.dense_halo)
        if icfg.tta if tta is None else tta:
            return self._tta_device(variables, tile_idx, scales)[0]
        if icfg.mode == "dense":
            pred, _, _ = self._dense_device(
                variables, tile_idx, icfg.dense_block, icfg.dense_halo)
        else:
            pred, _, _ = self._window_device(variables, tile_idx, scales)
        return pred

    @torch.inference_mode()
    def _tta_device(self, variables, tile_idx: int,
                    scales: Optional[Sequence[int]] = None,
                    mode: Optional[str] = None, block: Optional[int] = None,
                    halo: Optional[int] = None):
        """Test-time dihedral augmentation on the device: (pred uint8,
        fused probs). The tile's own padded crop [0, h+2p) x [0, w+2p)
        (the per-tile reflect fill makes it the tile mirror-padded alone)
        goes through each of the 8 transforms, so the valid block sits at
        [pad : pad+h'] for every one; window mode normalises each map by
        its vote counts; each map is transformed back, and the mean of
        the 8 is argmaxed. 8x the forwards of one prediction."""
        icfg = self.cfg.infer
        mode = icfg.mode if mode is None else mode
        block = icfg.dense_block if block is None else block
        halo = icfg.dense_halo if halo is None else halo
        h, w = (int(x) for x in self.valid_hw[tile_idx])
        p = self.pad
        solo = self._tile(tile_idx)[:h + 2 * p, :w + 2 * p]
        acc = None
        for k in range(8):
            tile_k = dihedral(solo, k).contiguous()
            hk, wk = (w, h) if k % 4 in (1, 3) else (h, w)
            if mode == "dense":
                _, prob_k, _ = self._dense_device(
                    variables, tile_idx, block, halo, override=(tile_k, hk, wk))
            else:
                _, valid_k, cnt_k = self._window_device(
                    variables, tile_idx, scales, override=(tile_k, hk, wk))
                prob_k = valid_k / torch.clamp(cnt_k, min=1e-9)[..., None]
            prob_k = dihedral_inv(prob_k, k)
            acc = prob_k if acc is None else acc + prob_k
        prob = acc / 8.0
        return torch.argmax(prob, dim=-1).to(torch.uint8), prob

    @staticmethod
    def _finish(pred, prob, cnt, return_probs: bool):
        pred_np = pred.cpu().numpy().astype(np.int32)
        if not return_probs:
            return pred_np, None
        prob_np = prob.cpu().numpy()
        if cnt is not None:
            prob_np = prob_np / np.maximum(cnt.cpu().numpy()[..., None], 1e-9)
        return pred_np, prob_np

    def predict_tile(self, variables, tile_idx: int,
                     scales: Optional[Sequence[int]] = None,
                     return_probs: bool = True, tta: Optional[bool] = None
                     ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Window-vote prediction of one tile over all scales: (pred (h,w)
        int32, vote-averaged probs (h,w,nc) float32 or None). With tta
        (default cfg.infer.tta) the probs are the 8-way dihedral fusion."""
        if self.cfg.infer.tta if tta is None else tta:
            pred, prob = self._tta_device(variables, tile_idx, scales, mode="window")
            return self._finish(pred, prob, None, return_probs=return_probs)
        return self._finish(*self._window_device(variables, tile_idx, scales),
                            return_probs=return_probs)

    def predict_tile_dense(self, variables, tile_idx: int, block: int = 256,
                           halo: int = 40, return_probs: bool = True,
                           tta: Optional[bool] = None
                           ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Dense prediction of one tile: (pred (h,w) int32, probs (h,w,nc)
        float32 or None). Exact for halo >= the receptive radius; halo
        must not exceed the tile mirror pad. With tta (default
        cfg.infer.tta) the probs are the 8-way dihedral fusion at the same
        block and halo."""
        self._check_halo(halo)
        if self.cfg.infer.tta if tta is None else tta:
            pred, prob = self._tta_device(variables, tile_idx, mode="dense",
                                          block=block, halo=halo)
            return self._finish(pred, prob, None, return_probs=return_probs)
        return self._finish(*self._dense_device(variables, tile_idx, block, halo),
                            return_probs=return_probs)


def _quiet(*_args, **_kw) -> None:
    pass


def validate_test(
    cfg: Config,
    variables: Dict[str, torch.Tensor],
    test_tiles: TileSet,
    device,
    scales: Optional[Sequence[int]] = None,
    log=print,
) -> Dict[str, object]:
    """Predict every test tile on `device` and report OA / kappa /
    per-class F1 / confusion, plus the per-tile label maps, like dynseg's
    validate_test, and the largest tensor collected for a window fold
    ("fold_peak_bytes", 0 in dense mode). `variables` is the port's float
    state_dict (moved to `device` where it lies elsewhere); `scales`
    overrides the inference scales (the scheduler's top-K). Under a
    data-parallel group every rank runs the forwards of its share and
    scores the same maps; only rank 0 logs."""
    if not parallel.is_main():
        log = _quiet
    inf = Inferencer(cfg, test_tiles, device=device)
    device = inf.device
    variables = {k: v.to(device) for k, v in variables.items()}
    if cfg.infer.quant != "none":
        variables = inf.enable_quant(variables)
        blocks = sorted(f"DilatedConvBlock_{k.split('.')[1]}"
                        for k in variables if k.endswith(".w_scale"))
        log(f"int8 serving path: quantized blocks {blocks}"
            f"{' + int8 exit' if 'exit.act_scale' in variables else ''}"
            f" (min_ch={cfg.infer.quant_min_ch}, calib pct="
            f"{cfg.infer.quant_calib_pct} over "
            f"{cfg.infer.quant_calib_crops} crops)")
    if cfg.infer.mode == "dense":
        log(
            "NOTE: dense mode is a whole-tile estimator; patch-trained "
            "models expect zero-padding context (receptive field > patch), "
            "so accuracy may differ from reference-parity window voting."
        )
    nc = cfg.model.num_classes
    cm = np.zeros((nc, nc), np.int64)
    erode_r = int(cfg.infer.eroded_boundary_radius)
    cm_eroded = np.zeros((nc, nc), np.int64) if erode_r > 0 else None
    preds: List[np.ndarray] = []

    def tile_cm(pred, mask):
        labels = torch.from_numpy(np.ascontiguousarray(mask)).to(device)
        return confusion_matrix(pred, labels, nc).cpu().numpy()

    # The largest tensor collected for a window fold over the tiles.
    fold_peak = 0
    # After Inferencer setup and calibration: pure predict + score time.
    t_infer0 = time.perf_counter()
    for t in range(test_tiles.num_tiles):
        pred = inf.predict_tile_device(variables, t, scales)
        fold_peak = max(fold_peak, inf.fold_peak_bytes)
        h, w = (int(x) for x in test_tiles.valid_hw[t])
        gt = test_tiles.masks[t, :h, :w]
        tcm = tile_cm(pred, gt)
        preds.append(pred.cpu().numpy().astype(np.int32))
        cm += tcm
        tile_scores = scores_from_confusion(tcm)
        log(
            f"tile {t}: OA={tile_scores['oa']:.4f} kappa={tile_scores['kappa']:.4f} "
            f"meanF1={tile_scores['mean_f1']:.4f}"
        )
        if cm_eroded is not None:
            cm_eroded += tile_cm(pred, erode_boundaries(gt, erode_r))
    scores = scores_from_confusion(cm)
    scores["predictions"] = preds
    scores["infer_wall_s"] = round(time.perf_counter() - t_infer0, 4)
    scores["fold_peak_bytes"] = fold_peak
    log(
        f"TOTAL: OA={scores['oa']:.4f} kappa={scores['kappa']:.4f} "
        f"meanF1={scores['mean_f1']:.4f} "
        f"F1={np.array2string(scores['f1'], precision=4)}"
    )
    if cm_eroded is not None:
        es = scores_from_confusion(cm_eroded)
        scores["eroded"] = es
        log(
            f"TOTAL (boundaries eroded {erode_r}px, ISPRS protocol): "
            f"OA={es['oa']:.4f} kappa={es['kappa']:.4f} "
            f"meanF1={es['mean_f1']:.4f} "
            f"F1={np.array2string(es['f1'], precision=4)}"
        )
    return scores
