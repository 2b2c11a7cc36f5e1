"""K2, the patch gather (counterpart of dynseg/ops/gather.py).

Every train, eval and BatchNorm-recalibration step assembles its batch on
the device from the padded tiles held there:

    positions (B, 3) int32 patch centres (tile, row, col), padded coords
    tiles (T, H, W, C) uint8 or float32, masks (T, H, W) uint8 or int32
      -> (B, s, s, C) float32 images, (x - mean) / std, dihedral-augmented
         (B, s, s)    int64 labels, augmented the same way

`gather_batch` launches the hand-written Hopper kernel
(csrc/patch_gather.cu), which fuses the crop, the normalisation and the
augment into one launch, for CUDA tensors; it takes the plain PyTorch
version, `gather_batch_ref`, only for tensors on the CPU. `launches`
counts the kernel's launches.
"""

from __future__ import annotations

import torch

# Kernel launches since the last reset (callers set it to 0).
launches = 0

# Shared memory a block may use on the H100 (227 KB).
_SMEM_LIMIT = 232448


def dihedral_batch(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Per-sample dihedral transform of a (B, s, s) or (B, s, s, C) batch,
    k (B,) in [0, 8): k < 4 is rot90^k over the two spatial axes; k >= 4
    flips the column axis first, then rot90^(k-4). The same passes as
    dynseg.ops.gather.dihedral_batch."""
    extra = x.dim() - 3

    def bc(m):
        return m.reshape((-1, 1, 1) + (1,) * extra)

    k = k.to(x.device)
    x = torch.where(bc(k >= 4), x.flip(2), x)
    r = k % 4
    x = torch.where(bc((r == 1) | (r == 3)), x.transpose(1, 2), x)
    x = torch.where(bc((r == 1) | (r == 2)), x.flip(1), x)
    x = torch.where(bc((r == 2) | (r == 3)), x.flip(2), x)
    return x


def _check(images, masks, mean, std, positions, aug_ids, size):
    if images.dim() != 4 or masks.shape != images.shape[:3]:
        raise ValueError(f"images (T,H,W,C) and masks (T,H,W) required, got "
                         f"{tuple(images.shape)}, {tuple(masks.shape)}")
    if images.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f"tiles must be uint8 or float32, got {images.dtype}")
    if masks.dtype not in (torch.uint8, torch.int32):
        raise TypeError(f"masks must be uint8 or int32, got {masks.dtype}")
    c = images.shape[3]
    if mean.shape != (c,) or std.shape != (c,):
        raise ValueError(f"mean/std must be ({c},)")
    b = positions.shape[0]
    if positions.shape != (b, 3) or aug_ids.shape != (b,):
        raise ValueError(f"positions (B,3) and aug_ids (B,) required, got "
                         f"{tuple(positions.shape)}, {tuple(aug_ids.shape)}")
    if not 1 <= size <= min(images.shape[1], images.shape[2]):
        raise ValueError(f"patch size {size} does not fit tiles "
                         f"{tuple(images.shape[1:3])}")


def _slice_start(start: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    """lax.dynamic_slice's start index: a negative start counts from the
    end (start + dim), then the start is clamped to [0, dim - size]."""
    return torch.where(start < 0, start + dim, start).clamp(0, dim - size)


def gather_batch_ref(images: torch.Tensor, masks: torch.Tensor,
                     mean: torch.Tensor, std: torch.Tensor,
                     positions: torch.Tensor, aug_ids: torch.Tensor,
                     size: int):
    """Plain PyTorch version of K2 on any device: crop at r - s//2 with the
    start placed as lax.dynamic_slice places it (`_slice_start`), normalise
    with a true division, then apply the dihedral transform."""
    _check(images, masks, mean, std, positions, aug_ids, size)
    t_n, h, w, _ = images.shape
    pos = positions.to(images.device).long()
    t = _slice_start(pos[:, 0], t_n, 1)
    r0 = _slice_start(pos[:, 1] - size // 2, h, size)
    c0 = _slice_start(pos[:, 2] - size // 2, w, size)
    ar = torch.arange(size, device=images.device)
    rows = (r0[:, None] + ar)[:, :, None]
    cols = (c0[:, None] + ar)[:, None, :]
    tt = t[:, None, None]
    imgs = (images[tt, rows, cols].float() - mean) / std
    labs = masks[tt, rows, cols].long()
    return dihedral_batch(imgs, aug_ids), dihedral_batch(labs, aug_ids)


def gather_batch(images: torch.Tensor, masks: torch.Tensor,
                 mean: torch.Tensor, std: torch.Tensor,
                 positions: torch.Tensor, aug_ids: torch.Tensor, size: int):
    """K2: (B, s, s, C) float32 images and (B, s, s) int64 labels.

    images (T,H,W,C) uint8/float32 and masks (T,H,W) uint8/int32, NHWC-
    contiguous; mean, std (C,) float32; positions (B,3) and aug_ids (B,)
    integer tensors on the tiles' device. CPU tensors take
    `gather_batch_ref`; CUDA tensors launch the kernel; anything else
    raises.
    """
    global launches
    if images.device.type == "cpu":
        return gather_batch_ref(images, masks, mean, std, positions, aug_ids,
                                size)
    if images.device.type != "cuda":
        raise RuntimeError(f"gather_batch: no kernel for device {images.device}")
    _check(images, masks, mean, std, positions, aug_ids, size)
    for t in (masks, mean, std, positions, aug_ids):
        if t.device != images.device:
            raise ValueError(f"operands on {t.device} and {images.device}")
    if not (images.is_contiguous() and masks.is_contiguous()):
        raise ValueError("gather_batch: tiles and masks must be contiguous")
    t_n, h, w, c = images.shape
    b = positions.shape[0]
    smem = (-(-size * size * c * images.element_size() // 16) * 16
            + size * size * masks.element_size())
    if smem > _SMEM_LIMIT:
        raise ValueError(f"gather_batch: a {size}^2 x {c} window needs {smem} "
                         f"bytes of shared memory (limit {_SMEM_LIMIT})")
    pos = positions.to(torch.int32).contiguous()
    aug = aug_ids.to(torch.int32).contiguous()
    m = mean.float().contiguous()
    sd = std.float().contiguous()
    imgs = torch.empty((b, size, size, c), device=images.device,
                       dtype=torch.float32)
    labs = torch.empty((b, size, size), device=images.device, dtype=torch.int64)
    if b == 0:
        return imgs, labs
    from dynseg_torch.ops._build import load_library

    lib = load_library()
    err = lib.dynseg_patch_gather(
        images.data_ptr(), masks.data_ptr(), m.data_ptr(), sd.data_ptr(),
        pos.data_ptr(), aug.data_ptr(), imgs.data_ptr(), labs.data_ptr(),
        b, t_n, h, w, c, size, int(images.dtype == torch.uint8),
        int(masks.dtype == torch.uint8),
        torch.cuda.current_stream(images.device).cuda_stream)
    if err:
        raise RuntimeError(f"gather_batch launch failed: CUDA error {err}")
    launches += 1
    return imgs, labs

