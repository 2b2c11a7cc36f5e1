// K4 for Hopper: the backward of the stride-1 SAME max-pool.
//
// Replaces the Pallas TPU kernel dynseg/ops/pool.py (`_bwd_kernel`,
// line 76, launched by `pallas_pool_bwd`, line 142). Given the pool's
// input x, its output y = maxpool_{window, SAME, stride 1}(x) and the
// cotangent g, all (B, H, W, C) float32, it computes the tie-split
// subgradient
//   cnt[s] = #{taps d of window s : x[s + d] == y[s]}
//   dx[r]  = sum_d valid(r, d) * [x[r] == y[r + d]] * g[r + d] / cnt[r + d]
// over the odd window's offsets d = (di, dj) in row-major order, which
// splits each window's gradient equally over its argmax ties and so
// conserves gradient mass.
//
// What bounds it on the H100: bytes. x, y and g are read and dx written
// once, 16 bytes a value: 1.73 GB, 0.52 ms at 3.35 TB/s, at the step's
// largest pool (100 x 65^2 x 256). The compares and adds (2 x window^2 a
// value) are far below the float32 rate.
//
// Two variants, chosen by the wrapper from the shape and the pointers
// (ops/pool.py `variant_for`):
//
//  * fused (C % 4 == 0, 16-byte aligned x, y, g; every pool of
//    dilated_icpr_rate6): one launch, one pass, no scratch in device
//    memory. A block owns a th x tw tile of one image and a slice of
//    CB = 4Q channels (16 at C >= 16). One thread copies, by TMA, x on the
//    tile plus a halo of 2r and y and g on the tile plus a ring of r into
//    shared memory, three boxes of 4-D tiled tensor maps over (C, W, H, B)
//    counted on one mbarrier. The maps fill elements outside the tensor
//    with NaN (CU_TENSOR_MAP_FLOAT_OOB_FILL_NAN_REQUEST_ZERO_FMA), and NaN
//    equals nothing, so taps outside the image drop out of both compares
//    with no bounds checks, as the plain version's NaN pad drops them. The
//    block then computes cnt and gdc = g / max(cnt, 1) on the tile and its
//    ring, in place of g in shared memory, and after a barrier dx on the
//    tile, 16 bytes (4 channels) a thread for every load and store. Halos
//    are read again by the neighbouring tiles, mostly from L2. Tiles are at
//    most 16 x 16, sized by the wrapper to cut H and W evenly (13 x 13 at
//    65 and 25); consecutive blocks take the channel slices of one tile, so
//    together they read whole pixels. 47.6 KB of shared memory at r = 1,
//    four blocks an SM, whose loads and compute overlap. A line buffer (a
//    block walking one image's full-width strip with a TMA ring of rows, so
//    that each value leaves device memory once) measured slower at every
//    shape tried, the step's six among them, and was not kept.
//  * twopass (any odd window and any H, W, C; PR 2's kernel, kept for C
//    not a multiple of 4 or a pointer that TMA cannot take): one thread per
//    (b, h, w, c); pass 1 writes gdc into a scratch tensor from the
//    wrapper, pass 2 gathers gdc over the windows that contain each input
//    position. Bounds are checked per tap. About 8 tensor passes, ~1 TB/s.
//
// Exactness: cnt is an exact count; __fdiv_rn and __fadd_rn (no FMA
// contraction), the sum from 0 in the offset order of the reference, so
// both variants equal the plain PyTorch version bit for bit. Where a tap
// does not match, the reference adds 0.0 and the kernels add nothing: the
// same, since a sum that starts at +0 is never -0.

#include <cuda_runtime.h>

#include "tma.cuh"  // stage barriers, tensor-map encoders

namespace {

// ---------------------------------------------------------------------------
// fused variant.
namespace fused {

constexpr int THREADS = 256;

struct Match {
  bool x, y, z, w;
};

__device__ __forceinline__ Match eq(float4 a, float4 b) {
  return {a.x == b.x, a.y == b.y, a.z == b.z, a.w == b.w};
}

__host__ __device__ __forceinline__ int round128(int bytes) { return (bytes + 127) / 128 * 128; }

// Q: float4s of channels a pixel holds in shared memory (CB = 4Q).
template <int Q>
__global__ void __launch_bounds__(THREADS)
pool_bwd_fused(const __grid_constant__ CUtensorMap xmap,
               const __grid_constant__ CUtensorMap ymap,
               const __grid_constant__ CUtensorMap gmap, float* __restrict__ dx, int H,
               int W, int C, int r, int th, int tw, int tiles_w, int tiles, int slices) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t pad = (128u - (raw & 127u)) & 127u;
  unsigned char* smem = smem_raw + pad;
  const uint32_t sbase = raw + pad;

  // Shared memory: x on (th + 4r) x (tw + 4r) pixels, y and g (then gdc)
  // on (th + 2r) x (tw + 2r), each [row][col][Q] float4, then the barrier.
  const int xw = tw + 4 * r, xh = th + 4 * r;
  const int yw = tw + 2 * r, yh = th + 2 * r;
  const int x_bytes = xh * xw * Q * 16, y_bytes = yh * yw * Q * 16;
  const int y_off = round128(x_bytes), g_off = y_off + round128(y_bytes);
  const int bar_off = g_off + round128(y_bytes);
  const float4* xs = reinterpret_cast<const float4*>(smem);
  const float4* ys = reinterpret_cast<const float4*>(smem + y_off);
  float4* gs = reinterpret_cast<float4*>(smem + g_off);
  const uint32_t bar = sbase + bar_off;

  int id = blockIdx.x;
  const int slice = id % slices;
  id /= slices;
  const int tile = id % tiles;
  const int b = id / tiles;
  const int h0 = (tile / tiles_w) * th, w0 = (tile % tiles_w) * tw;
  const int c0 = slice * 4 * Q;
  const int tid = threadIdx.x;

  if (tid == 0) {
    tma::mbar_init(bar, 1);
    tma::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    tma::mbar_expect_tx(bar, static_cast<uint32_t>(x_bytes + 2 * y_bytes));
    tma::load_tile_4d(sbase, &xmap, c0, w0 - 2 * r, h0 - 2 * r, b, bar);
    tma::load_tile_4d(sbase + y_off, &ymap, c0, w0 - r, h0 - r, b, bar);
    tma::load_tile_4d(sbase + g_off, &gmap, c0, w0 - r, h0 - r, b, bar);
  }
  tma::mbar_wait(bar, 0);

  // cnt and gdc on the tile and its ring. Ring pixel (i, j) is x's
  // (i + r, j + r); outside the image y is NaN, so cnt is 0 and gdc NaN,
  // which no compare below selects.
  const int ring = yh * yw * Q;
  for (int it = tid; it < ring; it += THREADS) {
    const int q = it % Q;
    const int p = it / Q;
    const int i = p / yw;
    const int j = p - i * yw;
    const float4 yv = ys[it];
    float4 cnt = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int di = 0; di <= 2 * r; ++di) {
      const float4* row = xs + ((i + di) * xw + j) * Q + q;
      for (int dj = 0; dj <= 2 * r; ++dj) {
        const Match m = eq(row[dj * Q], yv);
        if (m.x) cnt.x = __fadd_rn(cnt.x, 1.0f);
        if (m.y) cnt.y = __fadd_rn(cnt.y, 1.0f);
        if (m.z) cnt.z = __fadd_rn(cnt.z, 1.0f);
        if (m.w) cnt.w = __fadd_rn(cnt.w, 1.0f);
      }
    }
    const float4 g = gs[it];
    gs[it] = make_float4(__fdiv_rn(g.x, fmaxf(cnt.x, 1.0f)), __fdiv_rn(g.y, fmaxf(cnt.y, 1.0f)),
                         __fdiv_rn(g.z, fmaxf(cnt.z, 1.0f)), __fdiv_rn(g.w, fmaxf(cnt.w, 1.0f)));
  }
  __syncthreads();

  // dx on the tile: tile pixel (i, j) is x's (i + 2r, j + 2r) and the
  // ring's (i + r, j + r); its taps are the ring's (i + di, j + dj).
  const int inner = th * tw * Q;
  for (int it = tid; it < inner; it += THREADS) {
    const int q = it % Q;
    const int p = it / Q;
    const int i = p / tw;
    const int j = p - i * tw;
    const int h = h0 + i, w = w0 + j, c = c0 + 4 * q;
    if (h >= H || w >= W || c >= C) continue;
    const float4 xv = xs[((i + 2 * r) * xw + j + 2 * r) * Q + q];
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int di = 0; di <= 2 * r; ++di) {
      const int base = ((i + di) * yw + j) * Q + q;
      for (int dj = 0; dj <= 2 * r; ++dj) {
        const Match m = eq(xv, ys[base + dj * Q]);
        if (m.x || m.y || m.z || m.w) {
          const float4 gd = gs[base + dj * Q];
          if (m.x) acc.x = __fadd_rn(acc.x, gd.x);
          if (m.y) acc.y = __fadd_rn(acc.y, gd.y);
          if (m.z) acc.z = __fadd_rn(acc.z, gd.z);
          if (m.w) acc.w = __fadd_rn(acc.w, gd.w);
        }
      }
    }
    *reinterpret_cast<float4*>(dx + ((static_cast<long long>(b) * H + h) * W + w) * C + c) = acc;
  }
}

// A 4-D tiled map of a (B, H, W, C) float32 tensor with boxes of
// cb x bw x bh x 1 elements; NaN outside the tensor.
cudaError_t box_map(CUtensorMap* map, const void* t, int B, int H, int W, int C, int cb,
                    int bw, int bh) {
  PFN_cuTensorMapEncodeTiled_v12000 encode;
  const cudaError_t e = tma::encode_tiled(&encode);
  if (e != cudaSuccess) return e;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(C) * 4;
  const cuuint64_t strides[3] = {row, row * W, row * W * H};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cb), static_cast<cuuint32_t>(bw),
                             static_cast<cuuint32_t>(bh), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(t),
                              dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NAN_REQUEST_ZERO_FMA);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Bytes of dynamic shared memory a block takes (ops/pool.py `fused_smem`
// computes the same for the gate): the three boxes, each rounded to 128
// bytes, the barrier, and 128 bytes to align the base.
int smem_bytes(int Q, int r, int th, int tw) {
  const int x = round128((th + 4 * r) * (tw + 4 * r) * Q * 16);
  const int y = round128((th + 2 * r) * (tw + 2 * r) * Q * 16);
  return x + 2 * y + 8 + 128;
}

template <int Q>
int launch(const void* x, const void* y, const void* g, float* dx, int B, int H, int W, int C,
           int r, int th, int tw, cudaStream_t st) {
  const int cb = 4 * Q;
  CUtensorMap xmap, ymap, gmap;
  cudaError_t e = box_map(&xmap, x, B, H, W, C, cb, tw + 4 * r, th + 4 * r);
  if (e == cudaSuccess) e = box_map(&ymap, y, B, H, W, C, cb, tw + 2 * r, th + 2 * r);
  if (e == cudaSuccess) e = box_map(&gmap, g, B, H, W, C, cb, tw + 2 * r, th + 2 * r);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int smem = smem_bytes(Q, r, th, tw);
  auto* kernel = &pool_bwd_fused<Q>;
  static int allowed = 48 * 1024;  // the dynamic shared memory granted so far
  if (smem > allowed) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    allowed = smem;
  }
  const int tiles_w = (W + tw - 1) / tw;
  const int tiles = tiles_w * ((H + th - 1) / th);
  const int slices = (C + cb - 1) / cb;
  const long long blocks = static_cast<long long>(B) * tiles * slices;
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), THREADS, smem, st>>>(
      xmap, ymap, gmap, dx, H, W, C, r, th, tw, tiles_w, tiles, slices);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fused

// ---------------------------------------------------------------------------
// twopass variant (PR 2's kernel).
namespace twopass {

constexpr int THREADS = 256;

template <typename I>
__global__ void __launch_bounds__(THREADS)
pool_bwd_count(const float* __restrict__ x, const float* __restrict__ y,
               const float* __restrict__ g, float* __restrict__ gdc,
               I n, int H, int W, int C, int r) {
  const I idx = static_cast<I>(blockIdx.x) * THREADS + threadIdx.x;
  if (idx >= n) return;
  const I pix = idx / C;
  const int w = static_cast<int>(pix % W);
  const int h = static_cast<int>((pix / W) % H);
  const float yv = y[idx];
  float cnt = 0.0f;
  for (int di = -r; di <= r; ++di) {
    if (h + di < 0 || h + di >= H) continue;
    for (int dj = -r; dj <= r; ++dj) {
      if (w + dj < 0 || w + dj >= W) continue;
      const I d = (static_cast<I>(di) * W + dj) * C;
      if (x[idx + d] == yv) cnt = __fadd_rn(cnt, 1.0f);
    }
  }
  gdc[idx] = __fdiv_rn(g[idx], fmaxf(cnt, 1.0f));
}

template <typename I>
__global__ void __launch_bounds__(THREADS)
pool_bwd_scatter(const float* __restrict__ x, const float* __restrict__ y,
                 const float* __restrict__ gdc, float* __restrict__ dx,
                 I n, int H, int W, int C, int r) {
  const I idx = static_cast<I>(blockIdx.x) * THREADS + threadIdx.x;
  if (idx >= n) return;
  const I pix = idx / C;
  const int w = static_cast<int>(pix % W);
  const int h = static_cast<int>((pix / W) % H);
  const float xv = x[idx];
  float acc = 0.0f;
  for (int di = -r; di <= r; ++di) {
    if (h + di < 0 || h + di >= H) continue;
    for (int dj = -r; dj <= r; ++dj) {
      if (w + dj < 0 || w + dj >= W) continue;
      const I d = (static_cast<I>(di) * W + dj) * C;
      if (xv == y[idx + d]) acc = __fadd_rn(acc, gdc[idx + d]);
    }
  }
  dx[idx] = acc;
}

template <typename I>
int launch(const float* x, const float* y, const float* g, float* gdc, float* dx,
           I n, int H, int W, int C, int r, cudaStream_t st) {
  const unsigned blocks = static_cast<unsigned>((n + THREADS - 1) / THREADS);
  pool_bwd_count<I><<<blocks, THREADS, 0, st>>>(x, y, g, gdc, n, H, W, C, r);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  pool_bwd_scatter<I><<<blocks, THREADS, 0, st>>>(x, y, gdc, dx, n, H, W, C, r);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace twopass

}  // namespace

// x, y, g (B,H,W,C) f32 NHWC; dx the same shape; all contiguous on the
// card; window odd. variant 0 (twopass): gdc is a scratch tensor of x's
// shape, any H, W, C; the index math is 32-bit when the tensor has under
// 2^31 elements (108 M at 100 x 65^2 x 256), 64-bit otherwise. variant 1
// (fused): gdc is unused (null); C % 4 == 0, x, y, g 16-byte aligned, and
// th x tw the tile, at most 16 x 16. Launches on `stream`, does not
// synchronise, and returns cudaGetLastError(), or cudaErrorInvalidValue for
// a shape the variant does not take.
extern "C" int dynseg_pool_bwd(const void* x, const void* y, const void* g,
                               void* gdc, void* dx, int B, int H, int W,
                               int C, int window, int variant, int th, int tw,
                               void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  auto* dp = static_cast<float*>(dx);
  const int r = window / 2;
  if (variant == 1) {
    const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
    if (C % 4 || !aligned(x) || !aligned(y) || !aligned(g) || !aligned(dx) || th < 1 ||
        tw < 1 || th > 16 || tw > 16)
      return static_cast<int>(cudaErrorInvalidValue);
    switch (C >= 16 ? 4 : C / 4) {
      case 1: return fused::launch<1>(x, y, g, dp, B, H, W, C, r, th, tw, st);
      case 2: return fused::launch<2>(x, y, g, dp, B, H, W, C, r, th, tw, st);
      case 3: return fused::launch<3>(x, y, g, dp, B, H, W, C, r, th, tw, st);
      default: return fused::launch<4>(x, y, g, dp, B, H, W, C, r, th, tw, st);
    }
  }
  if (variant != 0 || gdc == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(B) * H * W * C;
  const auto* xp = static_cast<const float*>(x);
  const auto* yp = static_cast<const float*>(y);
  const auto* gp = static_cast<const float*>(g);
  auto* tp = static_cast<float*>(gdc);
  if (n < (1LL << 31) - twopass::THREADS)
    return twopass::launch<int>(xp, yp, gp, tp, dp, static_cast<int>(n), H, W, C, r, st);
  return twopass::launch<long long>(xp, yp, gp, tp, dp, n, H, W, C, r, st);
}
