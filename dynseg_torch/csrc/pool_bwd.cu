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
// Design: NHWC, one thread per (b, h, w, c) with c fastest, so a warp
// reads 32 consecutive channels of one pixel and of each neighbour tap.
// Pass 1 writes gdc = g / max(cnt, 1) into a scratch tensor that the
// wrapper allocates; pass 2 gathers, for each input position, gdc over the
// windows that contain it. Bounds are checked per tap, so any odd window
// and any H, W, C is taken; the TPU kernel's gates (C % 8, a channel block
// that fits VMEM) do not apply here.
//
// What bounds it on the H100: bytes. Pass 1 reads x (window^2 taps,
// mostly from L1/L2), y and g and writes gdc; pass 2 reads x, y and gdc
// (window^2 taps each) and writes dx: about 8 tensors of traffic from
// device memory, 3.5 GB at 100 x 65^2 x 256, about 1 ms at 3.35 TB/s.
// The index math is 32-bit where it fits (64-bit division by C and W
// costs more than the loads).
//
// Exactness: __fdiv_rn and __fadd_rn (no FMA contraction, the sum in the
// offset order of the reference), so dx equals the plain PyTorch version
// bit for bit.

#include <cuda_runtime.h>

namespace {

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

}  // namespace

// x, y, g (B,H,W,C) f32 NHWC; gdc (scratch) and dx the same shape; all
// contiguous on the card; window odd. Launches both passes on `stream`,
// does not synchronise, and returns cudaGetLastError(). The index math is
// 32-bit when the tensor has under 2^31 elements (every shape of the
// slice: 108 M at 100 x 65^2 x 256), 64-bit otherwise.
extern "C" int dynseg_pool_bwd(const void* x, const void* y, const void* g,
                               void* gdc, void* dx, int B, int H, int W,
                               int C, int window, void* stream) {
  const long long n = static_cast<long long>(B) * H * W * C;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const float*>(x);
  const auto* yp = static_cast<const float*>(y);
  const auto* gp = static_cast<const float*>(g);
  auto* tp = static_cast<float*>(gdc);
  auto* dp = static_cast<float*>(dx);
  const int r = window / 2;
  if (n < (1LL << 31) - THREADS)
    return launch<int>(xp, yp, gp, tp, dp, static_cast<int>(n), H, W, C, r, st);
  return launch<long long>(xp, yp, gp, tp, dp, n, H, W, C, r, st);
}
