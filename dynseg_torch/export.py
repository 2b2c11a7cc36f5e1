"""Serving export: standalone `torch.export` predictor artifacts
(counterpart of dynseg/export.py).

One trained predictor becomes three programs with symbolic (batch,
height, width), each saved with `torch.export.save`:

  * the nets are fully convolutional (stride 1, SAME), so one program
    serves every window scale and every dense block size;
  * params, BatchNorm statistics and the training normalization
    (mean/std) are baked in: callers pass raw pixel values and get
    per-pixel softmax probabilities back;
  * the programs are traced on the CPU and load on any torch device
    (`ExportedPredictor.load(..., device=)` moves them there).

A float artifact needs only torch to run. An int8 artifact calls K5 as
the registered operator `dynseg_torch::int8_block_conv` (one call per
quantized block), K6 as `dynseg_torch::max_pool_s1` (one call per pool;
`dynseg_torch::max_pool_s1_into` where a dense-wired net's block pools
into its slot of the feature buffer) and, where a block quantizes a float
map, K7 as
`dynseg_torch::quantize_s8`, so it needs `dynseg_torch` importable and,
on the card, the kernel library it builds; its manifest lists the ops its
programs call under "custom_ops" and `ExportedPredictor.load` registers
them first. An int8 artifact written
before K6 lists K5 alone (its pools are ATen's) and loads as it is.

Artifacts on disk (under <output_path>/export/):
    predictor.pt2, predictor_u8.pt2, dense_labels_u8.pt2   the programs
    manifest.json         model/provenance metadata + checksums
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib
import io
import json
import os
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from dynseg_torch.config import Config

ARTIFACT = "predictor.pt2"
MANIFEST = "manifest.json"
# The operators an int8 artifact calls, each with the module that
# registers it.
INT8_OP = "dynseg_torch::int8_block_conv"
POOL_OP = "dynseg_torch::max_pool_s1"
POOL_INTO_OP = "dynseg_torch::max_pool_s1_into"
QUANT_OP = "dynseg_torch::quantize_s8"
CUSTOM_OPS = {INT8_OP: "dynseg_torch.ops.int8_conv", POOL_OP: "dynseg_torch.ops.pool",
              POOL_INTO_OP: "dynseg_torch.ops.pool", QUANT_OP: "dynseg_torch.ops.pool"}


class _Entry(nn.Module):
    """One entry point: raw pixels (B, H, W, bands) -> f32 softmax, or u8
    argmax labels with `halo` pixels cropped from each side."""

    def __init__(self, apply: Callable, mean: np.ndarray, std: np.ndarray,
                 halo: Optional[int]):
        super().__init__()
        self.apply_fn = apply  # a float net registers as a submodule
        self.register_buffer("mean", torch.as_tensor(np.asarray(mean, np.float32)))
        self.register_buffer("std", torch.as_tensor(np.asarray(std, np.float32)))
        self.halo = halo

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        logits = self.apply_fn((x.float() - self.mean) / self.std)
        p = torch.softmax(logits.float(), dim=-1)
        if self.halo is None:
            return p
        if self.halo > 0:  # halo 0 would slice [0:-0], an empty map
            k = self.halo
            p = p[:, k:p.shape[1] - k, k:p.shape[2] - k]
        return torch.argmax(p, dim=-1).to(torch.uint8)


def _export(entry: _Entry, bands: int, dtype: torch.dtype, min_hw: int = 1):
    """A `torch.export` program of `entry` with symbolic (b, h, w), h and
    w >= min_hw. The example has b, h and w >= 2 and distinct: a 1 would
    make that dimension a constant."""
    from torch.export import Dim

    dims = {0: Dim("b", min=1), 1: Dim("h", min=min_hw), 2: Dim("w", min=min_hw)}
    example = torch.zeros((2, min_hw + 17, min_hw + 19, bands), dtype=dtype)
    return torch.export.export(entry, (example,), dynamic_shapes=(dims,))


def _apply_fn(cfg: Config, variables, quant_variables, device="cpu"):
    """The forward on `device`: the float net with its state_dict loaded,
    or the int8 forward over K5 operands packed once, before tracing, so
    that they are the program's constants. The operands are folded where
    the variables live, as the live forward folds them there (rsqrt
    rounds otherwise on the card than on the CPU), then moved."""
    from dynseg_torch.models.dilated import build_model
    from dynseg_torch.ops import quant

    sd = {k: v.detach().to(device) for k, v in
          (quant_variables if quant_variables is not None else variables).items()}
    if quant_variables is not None:
        packed = {name: dataclasses.replace(pc, w=pc.w.to(device), a=pc.a.to(device),
                                            b=pc.b.to(device))
                  for name, pc in quant.pack_blocks(cfg.model, quant_variables).items()}
        return lambda x: quant._forward(cfg.model, sd, x, packed=packed)
    net = build_model(cfg.model, cfg.model.num_input_bands).to(device)
    net.load_state_dict(sd)
    return net


def export_predictor(
    cfg: Config,
    variables,
    mean: np.ndarray,
    std: np.ndarray,
    out_dir: str,
    platforms: Sequence[str] = ("tpu", "cpu"),
    extra_meta: Optional[dict] = None,
    quant_variables=None,
) -> str:
    """Save the predictor with everything baked in, as the three entry
    points of the reference (all b/h/w-symbolic):

      probs          f32[b,h,w,C] -> f32[b,h,w,nc]     window voting
      probs_u8       u8 [b,h,w,C] -> f32[b,h,w,nc]     4x smaller upload
      dense_labels   u8 [b,h,w,C] -> u8[b,h-2k,w-2k]   k = dense_halo;
                                                       argmax on the device,
                                                       halo cropped

    `variables` is the port's float state_dict; `quant_variables`, the
    int8 one (`Inferencer.enable_quant`), makes an int8 artifact. The
    programs compute in cfg.model.compute_dtype. `platforms` names the
    torch devices to load the saved programs on and check against the
    live forward there; a name that is no torch device type (the
    reference's "tpu") is skipped, and the manifest's "platforms" lists
    the devices checked. Returns the export directory path."""
    apply = _apply_fn(cfg, variables, quant_variables)
    halo = int(cfg.infer.dense_halo)
    bands = int(cfg.model.num_input_bands)
    programs = {
        "probs": (ARTIFACT, _export(_Entry(apply, mean, std, None),
                                    bands, torch.float32)),
        "probs_u8": ("predictor_u8.pt2", _export(
            _Entry(apply, mean, std, None), bands, torch.uint8)),
        # A crop of symbolic extent h - 2k is specialised away from 1 by
        # torch.export (a contiguity check of the slice), so this program
        # takes crops of 2 x 2 pixels or more; `dense_labels_device` sends
        # a thinner one through probs_u8.
        "dense_labels": ("dense_labels_u8.pt2", _export(
            _Entry(apply, mean, std, halo), bands, torch.uint8,
            min_hw=_labels_min_hw(halo))),
    }
    os.makedirs(out_dir, exist_ok=True)
    arts = {}
    for name, (fname, program) in programs.items():
        buf = io.BytesIO()
        torch.export.save(program, buf)
        payload = buf.getvalue()
        with open(os.path.join(out_dir, fname), "wb") as f:
            f.write(payload)
        arts[name] = {"file": fname,
                      "sha256": hashlib.sha256(payload).hexdigest()}

    quantized = quant_variables is not None
    manifest = {
        "format": "torch.export/pt2",
        "artifact": ARTIFACT,          # alias of artifacts.probs
        "artifacts": arts,
        "sha256": arts["probs"]["sha256"],
        "dense_labels_halo": halo,
        "platforms": [],
        "torch_version": torch.__version__,
        "signature": {
            "input": f"f32[b, h, w, {bands}] raw pixel values",
            "output": f"f32[b, h, w, {cfg.model.num_classes}] softmax probabilities",
        },
        "net_type": cfg.model.net_type,
        "num_classes": cfg.model.num_classes,
        "num_input_bands": bands,
        "compute_dtype": cfg.model.compute_dtype,
        # From the artifact's contents, not cfg.
        "quant": "int8" if quantized else "none",
        "quant_blocks": (sorted(f"DilatedConvBlock_{k.split('.')[1]}"
                                for k in quant_variables if k.endswith(".w_scale"))
                         if quantized else []),
        "quant_exit": quantized and "exit.act_scale" in quant_variables,
        "normalization": {
            "mean": np.asarray(mean).tolist(),
            "std": np.asarray(std).tolist(),
        },
        "train_scales": list(cfg.sched.values),
        "inference": {
            "window_scales": list(cfg.infer.scales),
            "stride_fraction": cfg.infer.stride_fraction,
            "dense_halo": cfg.infer.dense_halo,
        },
    }
    if quantized:
        called = {str(n.target) for _, program in programs.values()
                  for n in program.graph.nodes}
        manifest["custom_ops"] = [op for op in CUSTOM_OPS
                                  if any(op.replace("::", ".") + "." in t for t in called)]
    manifest.update(extra_meta or {})
    _write_manifest(out_dir, manifest)
    checked = [d for d in platforms if _torch_device_type(d)]
    for device in checked:
        live = _Entry(_apply_fn(cfg, variables, quant_variables, device),
                      mean, std, None).to(device)
        _check_on(out_dir, device, live, halo, bands)
    manifest["platforms"] = checked
    _write_manifest(out_dir, manifest)
    return out_dir


def _labels_min_hw(halo: int) -> int:
    """The dense_labels program's least input extent: a 2-pixel crop."""
    return 2 * halo + 2 if halo > 0 else 1


def _write_manifest(out_dir: str, manifest: dict) -> None:
    with open(os.path.join(out_dir, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2)


def _torch_device_type(name: str) -> bool:
    try:
        torch.device(name)
    except RuntimeError:
        return False
    return True


@torch.inference_mode()
def _check_on(out_dir: str, device: str, live: _Entry, halo: int,
              bands: int) -> None:
    """Load the saved programs on `device` and hold each entry point to
    the live forward there (`live`), on seeded raw pixels: probabilities
    within 1e-5, labels equal wherever the live top two are further
    apart."""
    pred = ExportedPredictor.load(out_dir, device=device)
    rng = np.random.default_rng(0)
    x8 = rng.integers(0, 256, (1, 2 * halo + 3, 2 * halo + 5, bands), dtype=np.uint8)
    got = {"probs": pred.probs(x8.astype(np.float32)), "probs_u8": pred.probs(x8)}
    labels = pred.dense_labels_device(x8).cpu().numpy()
    want = live(torch.from_numpy(x8).to(device)).cpu().numpy()
    for name, p in got.items():
        if not np.allclose(p, want, rtol=0, atol=1e-5):
            raise RuntimeError(f"export check on {device}: {name} differs from "
                               f"the live forward by {np.abs(p - want).max():g}")
    crop = want[:, halo:want.shape[1] - halo, halo:want.shape[2] - halo]
    top2 = np.sort(crop, axis=-1)[..., -2:]
    sure = top2[..., 1] - top2[..., 0] > 1e-5
    if not np.array_equal(labels[sure], crop.argmax(-1)[sure]):
        raise RuntimeError(f"export check on {device}: dense_labels differs from "
                           f"the live forward's argmax")


@dataclasses.dataclass
class ExportedPredictor:
    """A loaded serving artifact: `.probs(raw_pixels)` / `.predict(raw)`.

    Needs torch and the artifact's files (and, for an int8 artifact,
    `dynseg_torch` for its operator). The `*_device` variants return
    tensors on the device without waiting for them: launches are
    asynchronous, so a caller iterating blocks can enqueue several and
    copy each to the host later (the copy is where the host waits)."""

    manifest: dict
    device: torch.device
    _fns: dict
    _payloads: dict

    @classmethod
    def load(cls, export_dir: str, device="cuda") -> "ExportedPredictor":
        """Read the manifest and every program's bytes, refusing a file
        whose sha256 differs from the manifest's; programs are
        deserialized at their first call, onto `device`. A card asked for
        where none is visible is an error."""
        with open(os.path.join(export_dir, MANIFEST)) as f:
            manifest = json.load(f)
        device = torch.device(device)
        if device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("no CUDA card is visible; load the artifact "
                                   "with device='cpu' to run it on the CPU")
            if device.index is None:
                device = torch.device("cuda", torch.cuda.current_device())
            # A float32 program keeps float32 convolutions, as the live
            # nets do (cuDNN would run them in TF32 by default).
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        for op in manifest.get("custom_ops", ()):
            if op not in CUSTOM_OPS:
                raise ValueError(f"artifact under {export_dir} calls {op}, which "
                                 f"this version of dynseg_torch does not register")
            importlib.import_module(CUSTOM_OPS[op])
        arts = manifest.get("artifacts") or {
            "probs": {"file": manifest["artifact"], "sha256": manifest["sha256"]},
        }
        payloads = {}
        for name, rec in arts.items():
            with open(os.path.join(export_dir, rec["file"]), "rb") as f:
                payload = f.read()
            digest = hashlib.sha256(payload).hexdigest()
            if digest != rec["sha256"]:
                raise ValueError(
                    f"artifact checksum mismatch for {rec['file']} under "
                    f"{export_dir}: manifest says {rec['sha256'][:12]}…, "
                    f"file is {digest[:12]}… — corrupted or tampered export")
            payloads[name] = payload
        return cls(manifest=manifest, device=device, _fns={}, _payloads=payloads)

    def has(self, name: str) -> bool:
        return name in self._payloads or name in self._fns

    def _fn(self, name: str):
        if name not in self._fns:
            from torch.export.passes import move_to_device_pass

            program = torch.export.load(io.BytesIO(self._payloads.pop(name)))
            if self.device.type != "cpu":
                program = move_to_device_pass(program, self.device)
            self._fns[name] = program.module()
        return self._fns[name]

    def _check(self, x: np.ndarray) -> None:
        if x.ndim != 4 or x.shape[-1] != self.manifest["num_input_bands"]:
            raise ValueError(
                f"expected (B, H, W, {self.manifest['num_input_bands']}) "
                f"input, got {x.shape}")

    @torch.inference_mode()
    def _call(self, name: str, x: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(x)
        if self.device.type == "cuda":
            # Handler and batcher threads start on device 0: name ours.
            torch.cuda.set_device(self.device)
            # From pinned memory the upload waits for no earlier launch
            # (a pageable copy waits for the stream to drain).
            t = t.pin_memory().to(self.device, non_blocking=True)
        else:
            t = t.to(self.device)
        return self._fn(name)(t)

    def probs_device(self, x: np.ndarray) -> torch.Tensor:
        """(B, H, W, bands) raw pixels -> f32 softmax on the device, not
        waited for. uint8 input goes through the u8 entry point."""
        if np.asarray(x).dtype == np.uint8 and self.has("probs_u8"):
            x = np.ascontiguousarray(x)
            self._check(x)
            return self._call("probs_u8", x)
        x = np.ascontiguousarray(x, np.float32)
        self._check(x)
        return self._call("probs", x)

    def probs(self, x: np.ndarray) -> np.ndarray:
        """(B, H, W, bands) raw pixels -> (B, H, W, classes) softmax."""
        return self.probs_device(x).cpu().numpy()

    def dense_labels_device(self, x: np.ndarray) -> torch.Tensor:
        """u8 raw pixels (halo included) -> u8 argmax labels on the
        device, with the manifest's dense_labels_halo cropped off there:
        the labels fast path downloads b*h*w bytes. A crop under 2 pixels
        on a side takes the probs_u8 program, then the same argmax and
        crop on the device."""
        x = np.ascontiguousarray(np.asarray(x).astype(np.uint8))
        self._check(x)
        k = int(self.manifest["dense_labels_halo"])
        if min(x.shape[1:3]) >= _labels_min_hw(k):
            return self._call("dense_labels", x)
        p = self._call("probs_u8", x)[:, k:x.shape[1] - k, k:x.shape[2] - k]
        return torch.argmax(p, dim=-1).to(torch.uint8)

    def predict(self, x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Argmax labels + probabilities for a raw-pixel batch."""
        p = self.probs(x)
        return p.argmax(axis=-1).astype(np.int32), p
