// K2 for Hopper: the patch gather of every train, eval and BatchNorm
// recalibration step.
//
// Replaces the Pallas TPU kernel dynseg/ops/pallas_gather.py
// (`_gather_kernel`, line 92, launched by `pallas_gather_batch`, line 180).
// For each of B patch centres (tile, row, col) in padded-tile coordinates
// it cuts the s x s window that starts at (row - s/2, col - s/2) out of the
// device-resident (T, H, W, C) tiles and their (T, H, W) label masks,
// normalises the image as (x - mean_c) / std_c, applies the sample's
// dihedral transform (aug id in [0, 8), the convention of
// dynseg/ops/gather.py:dihedral_batch) and writes (B, s, s, C) float32
// images and (B, s, s) int64 labels. Window starts are placed as
// lax.dynamic_slice places them (negative from the end, then clamped).
//
// Design: one block per patch. The block stages its window and the
// window's labels row by row in shared memory (s*s*(C+1) bytes for uint8
// tiles and masks, 65^2 * 4 = 16.9 KB at s = 65, C = 3); each window row
// is s*C contiguous elements of the tile, so consecutive threads load
// consecutive addresses. The store then walks the OUTPUT in order
// (coalesced writes) and reads each value from the transformed source
// position in shared memory, so the augment is fused into the store; the
// TPU kernel left it to a separate pass. The TPU kernel's label interleave
// existed for its DMA descriptors and is not needed here.
//
// What bounds it on the H100: launch and latency, not bytes. A step at
// B = 100, s = 65 moves about 1.3 MB of uint8 window and writes 5 MB of
// float32 and 3.4 MB of int64 labels, microseconds at 3.35 TB/s; so the
// gather is one launch per step, on PyTorch's stream, with no host sync.
//
// Exactness: the normalisation uses __fsub_rn and __fdiv_rn (a true
// division, as the plain PyTorch version computes it), so the images equal
// the plain version bit for bit and the labels are copied.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

// Source pixel (row, col) of output pixel (i, j) under dihedral id k:
// the inverse of dihedral_batch's passes (flip columns if k >= 4; then,
// with r = k % 4, transpose if r is odd, flip rows if r is 1 or 2, flip
// columns if r is 2 or 3), undone from the last pass to the first.
__device__ __forceinline__ int source_pixel(int i, int j, int k, int s) {
  const int r = k & 3;
  if (r == 2 || r == 3) j = s - 1 - j;
  if (r == 1 || r == 2) i = s - 1 - i;
  if (r & 1) {
    const int t = i;
    i = j;
    j = t;
  }
  if (k >= 4) j = s - 1 - j;
  return i * s + j;
}

// lax.dynamic_slice's start index: a negative start counts from the end,
// then the start is clamped to [0, dim - size].
__device__ __forceinline__ int slice_start(int start, int dim, int size) {
  if (start < 0) start += dim;
  return min(max(start, 0), dim - size);
}

template <typename TI, typename TM>
__global__ void __launch_bounds__(THREADS)
patch_gather_kernel(const TI* __restrict__ images, const TM* __restrict__ masks,
                    const float* __restrict__ mean,
                    const float* __restrict__ stdv,
                    const int* __restrict__ pos, const int* __restrict__ aug,
                    float* __restrict__ out_img,
                    long long* __restrict__ out_lab, int T, int H, int W,
                    int C, int s, int mask_offset) {
  extern __shared__ __align__(16) unsigned char smem[];
  TI* win = reinterpret_cast<TI*>(smem);
  TM* wlab = reinterpret_cast<TM*>(smem + mask_offset);

  const int b = blockIdx.x;
  const int t = slice_start(pos[3 * b], T, 1);
  const int r0 = slice_start(pos[3 * b + 1] - s / 2, H, s);
  const int c0 = slice_start(pos[3 * b + 2] - s / 2, W, s);
  const int k = aug[b];

  const int row = s * C;
  const long long img_base = ((static_cast<long long>(t) * H + r0) * W + c0) * C;
  for (int idx = threadIdx.x; idx < s * row; idx += THREADS) {
    const int i = idx / row;
    win[idx] = images[img_base + static_cast<long long>(i) * W * C + (idx - i * row)];
  }
  const long long lab_base = (static_cast<long long>(t) * H + r0) * W + c0;
  for (int idx = threadIdx.x; idx < s * s; idx += THREADS) {
    const int i = idx / s;
    wlab[idx] = masks[lab_base + static_cast<long long>(i) * W + (idx - i * s)];
  }
  __syncthreads();

  float* img = out_img + static_cast<long long>(b) * s * s * C;
  for (int o = threadIdx.x; o < s * row; o += THREADS) {
    const int pix = o / C;
    const int c = o - pix * C;
    const int i = pix / s;
    const float v = static_cast<float>(win[source_pixel(i, pix - i * s, k, s) * C + c]);
    img[o] = __fdiv_rn(__fsub_rn(v, mean[c]), stdv[c]);
  }
  long long* lab = out_lab + static_cast<long long>(b) * s * s;
  for (int o = threadIdx.x; o < s * s; o += THREADS) {
    const int i = o / s;
    lab[o] = static_cast<long long>(wlab[source_pixel(i, o - i * s, k, s)]);
  }
}

template <typename TI, typename TM>
int launch(const void* images, const void* masks, const float* mean,
           const float* stdv, const int* pos, const int* aug, float* out_img,
           long long* out_lab, int B, int T, int H, int W, int C, int s,
           cudaStream_t stream) {
  const int img_bytes = s * s * C * static_cast<int>(sizeof(TI));
  const int mask_offset = (img_bytes + 15) / 16 * 16;
  const int smem = mask_offset + s * s * static_cast<int>(sizeof(TM));
  auto* kernel = &patch_gather_kernel<TI, TM>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<B, THREADS, smem, stream>>>(
      static_cast<const TI*>(images), static_cast<const TM*>(masks), mean,
      stdv, pos, aug, out_img, out_lab, T, H, W, C, s, mask_offset);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// images (T,H,W,C) uint8 (img_u8 = 1) or float32; masks (T,H,W) uint8
// (mask_u8 = 1) or int32; mean, std (C) f32; positions (B,3) and aug (B)
// int32; out_img (B,s,s,C) f32; out_lab (B,s,s) int64; all contiguous on
// the card. Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() (or the error of raising the shared-memory limit).
extern "C" int dynseg_patch_gather(const void* images, const void* masks,
                                   const void* mean, const void* stdv,
                                   const void* positions, const void* aug,
                                   void* out_img, void* out_lab, int B, int T,
                                   int H, int W, int C, int s, int img_u8,
                                   int mask_u8, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* m = static_cast<const float*>(mean);
  const auto* sd = static_cast<const float*>(stdv);
  const auto* p = static_cast<const int*>(positions);
  const auto* a = static_cast<const int*>(aug);
  auto* oi = static_cast<float*>(out_img);
  auto* ol = static_cast<long long*>(out_lab);
  if (img_u8) {
    return mask_u8 ? launch<uint8_t, uint8_t>(images, masks, m, sd, p, a, oi, ol, B, T, H, W, C, s, st)
                   : launch<uint8_t, int32_t>(images, masks, m, sd, p, a, oi, ol, B, T, H, W, C, s, st);
  }
  return mask_u8 ? launch<float, uint8_t>(images, masks, m, sd, p, a, oi, ol, B, T, H, W, C, s, st)
                 : launch<float, int32_t>(images, masks, m, sd, p, a, oi, ol, B, T, H, W, C, s, st);
}
