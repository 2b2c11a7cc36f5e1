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
// Design: a flat grid over the output, so a batch fills the card (B = 100
// at s = 25 is 78k threads in 305 blocks, at s = 65 528k in 2,063, where
// one block a patch gave 100). A thread writes 16 bytes: 4 consecutive
// float32 of the flattened (B, s, s, C) images, or 2 consecutive int64
// labels. Each value is read straight from its source pixel through the
// inverse dihedral map (read-only loads of the uint8 or float32 tiles,
// whose windows, ~1.3 MB a batch, stay in L2), with no shared memory and
// no barrier: staging bands of the window in shared memory measured
// slower, and the transposing augments no slower than the others. A thread
// divides once, for its first value's (patch, row, column, channel), and
// carries that index through the other values; the index math is 32-bit. The TPU kernel's label interleave existed for its DMA
// descriptors and is not needed here.
//
// What bounds it on the H100: bytes, and at these sizes the launch. A step
// at B = 100, s = 65 reads about 1.7 MB and writes 5 MB of float32 and
// 3.4 MB of int64 labels, 3 us at 3.35 TB/s; so the gather is one launch
// per step, on PyTorch's stream, with no host sync.
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
__device__ __forceinline__ int2 source_pixel(int i, int j, int k, int s) {
  const int r = k & 3;
  if (r == 2 || r == 3) j = s - 1 - j;
  if (r == 1 || r == 2) i = s - 1 - i;
  if (r & 1) {
    const int t = i;
    i = j;
    j = t;
  }
  if (k >= 4) j = s - 1 - j;
  return make_int2(i, j);
}

// lax.dynamic_slice's start index: a negative start counts from the end,
// then the start is clamped to [0, dim - size].
__device__ __forceinline__ int slice_start(int start, int dim, int size) {
  if (start < 0) start += dim;
  return min(max(start, 0), dim - size);
}

// Patch b's window: the offset of its first pixel in the tiles (in
// pixels) and its dihedral id.
struct Patch {
  long long base;
  int k;
};

__device__ __forceinline__ Patch patch(const int* __restrict__ pos,
                                       const int* __restrict__ aug, int b, int T,
                                       int H, int W, int s) {
  const int t = slice_start(__ldg(pos + 3 * b), T, 1);
  const int r0 = slice_start(__ldg(pos + 3 * b + 1) - s / 2, H, s);
  const int c0 = slice_start(__ldg(pos + 3 * b + 2) - s / 2, W, s);
  return {(static_cast<long long>(t) * H + r0) * W + c0, __ldg(aug + b)};
}

// Output position (b, i, j, c), carried forward one value at a time.
struct Cursor {
  int b, i, j, c;
  __device__ __forceinline__ void next(int s, int C) {
    if (++c < C) return;
    c = 0;
    if (++j < s) return;
    j = 0;
    if (++i < s) return;
    i = 0;
    ++b;
  }
};

// A flat grid over the output: the first threads take the flattened
// (B, s, s, C) images in quads of 4 floats, the rest the flattened labels
// in pairs, 16 bytes a thread either way. A quad or pair may span two
// patches (when s*s*C or s*s is not a multiple of 4 or 2); the cursor then
// looks the next patch's window up.
template <typename TI, typename TM>
__global__ void __launch_bounds__(THREADS)
patch_gather_kernel(const TI* __restrict__ images, const TM* __restrict__ masks,
                    const float* __restrict__ mean, const float* __restrict__ stdv,
                    const int* __restrict__ pos, const int* __restrict__ aug,
                    float* __restrict__ out_img, long long* __restrict__ out_lab,
                    int n_img, int n_lab, int img_threads, int T, int H, int W, int C,
                    int s) {
  const int tid = blockIdx.x * THREADS + threadIdx.x;
  Cursor at;
  if (tid < img_threads) {
    const int e0 = 4 * tid;
    const int len = s * s * C;
    at.b = e0 / len;
    const int rem = e0 - at.b * len;
    const int pix = rem / C;
    at.c = rem - pix * C;
    at.i = pix / s;
    at.j = pix - at.i * s;
    int b = at.b;
    Patch p = patch(pos, aug, b, T, H, W, s);
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (e0 + u < n_img) {
        if (at.b != b) {
          b = at.b;
          p = patch(pos, aug, b, T, H, W, s);
        }
        const int2 src = source_pixel(at.i, at.j, p.k, s);
        const float x = static_cast<float>(
            __ldg(images + (p.base + src.x * W + src.y) * C + at.c));
        v[u] = __fdiv_rn(__fsub_rn(x, __ldg(mean + at.c)), __ldg(stdv + at.c));
      }
      at.next(s, C);
    }
    if (e0 + 4 <= n_img) {
      *reinterpret_cast<float4*>(out_img + e0) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      for (int u = 0; e0 + u < n_img; ++u) out_img[e0 + u] = v[u];
    }
    return;
  }
  const int e0 = 2 * (tid - img_threads);
  if (e0 >= n_lab) return;
  at.b = e0 / (s * s);
  const int pix = e0 - at.b * s * s;
  at.i = pix / s;
  at.j = pix - at.i * s;
  at.c = 0;
  long long lab[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    if (e0 + u < n_lab) {
      const Patch p = patch(pos, aug, at.b, T, H, W, s);
      const int2 src = source_pixel(at.i, at.j, p.k, s);
      lab[u] = static_cast<long long>(__ldg(masks + p.base + src.x * W + src.y));
    }
    at.next(s, 1);
  }
  if (e0 + 2 <= n_lab) {
    *reinterpret_cast<longlong2*>(out_lab + e0) = make_longlong2(lab[0], lab[1]);
  } else {
    out_lab[e0] = lab[0];
  }
}

template <typename TI, typename TM>
int launch(const void* images, const void* masks, const float* mean,
           const float* stdv, const int* pos, const int* aug, float* out_img,
           long long* out_lab, int B, int T, int H, int W, int C, int s,
           cudaStream_t stream) {
  // The index math is 32-bit: every flat index, and the one past the
  // last quad, must fit.
  const long long n_img = static_cast<long long>(B) * s * s * C;
  if (n_img + 4 >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const int n_lab = B * s * s;
  const int img_threads = static_cast<int>((n_img + 3) / 4);
  const int threads = img_threads + (n_lab + 1) / 2;
  patch_gather_kernel<TI, TM><<<(threads + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
      static_cast<const TI*>(images), static_cast<const TM*>(masks), mean, stdv, pos, aug,
      out_img, out_lab, static_cast<int>(n_img), n_lab, img_threads, T, H, W, C, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// images (T,H,W,C) uint8 (img_u8 = 1) or float32; masks (T,H,W) uint8
// (mask_u8 = 1) or int32; mean, std (C) f32; positions (B,3) and aug (B)
// int32; out_img (B,s,s,C) f32 and out_lab (B,s,s) int64, 16-byte aligned;
// all contiguous on the card; B*s*s*C + 4 < 2^31. Launches on `stream`,
// does not synchronise, and returns cudaGetLastError(), or
// cudaErrorInvalidValue for a batch past that limit.
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
