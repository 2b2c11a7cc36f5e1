// K6 for Hopper: the stride-1 SAME max-pool forward of the int8 forward.
//
// Replaces none in Pallas: `lax.reduce_window` on int8,
// dynseg/ops/quant.py:192-220, which XLA runs as one pass over the int8
// codes ("at 1/4 the pool HBM traffic"). The port had pooled those codes in
// float32 through ATen (a cast, max_pool2d_with_indices writing an int64
// index for every value, a cast back) and quantized the float block's
// output in three passes before its pool.
//
// One launch computes y = maxpool_{window, SAME, stride 1}(x) of an NHWC
// tensor, reading each input value once from device memory and writing
// only the max, in one of three load/store modes (ops/pool.py `fwd_mode`,
// from the input's dtype and whether an out-scale is given):
//   i8      int8 codes -> int8 (K5's requantized output);
//   f32_i8  float32 -> int8: the window's max m in float32, then once
//           rint(clamp(m / sx, -127, 127)); the quantize is monotone
//           non-decreasing, so this equals quantize-then-pool;
//   f32     float32 -> float32.
//
// What bounds it on the H100: bytes. The dense int8 forward's six pools
// (8 x 336^2; C 64 and 64 f32, 128 f32 -> i8, 128 and 192 i8, 192 f32)
// read and write 3.47 GB, 1.04 ms at 3.35 TB/s; a compare per tap and
// value is far under any compute rate.
//
// Design: a thread owns 16 bytes of one pixel's channels (16 codes or 4
// floats), neighbouring threads on neighbouring channels and then on the
// pixels of an image row, and walks a strip of `rows` output rows down H.
// For each input row it takes the max over the window's taps along W (16-
// byte loads that neighbouring threads share through L1), and keeps the
// last `window` row maxima in registers, so the max along H loads nothing:
// a strip reads its rows once, plus the window - 1 rows it shares with the
// next strip, whose blocks come next in launch order and find them in L2.
// Taps outside the image are skipped: every window holds its own centre,
// so no pad value can win and none is needed. A C whose pixel is not whole
// 16-byte pieces, or a pointer or an output pixel stride off 16 bytes,
// takes the same kernel with one element a thread (the caller names the
// path: ops/pool.py `fwd_path`). Any window 1..7 with XLA's SAME split:
// (window-1)/2 before, the rest after.
//
// The output may be a channel slot of a wider NHWC buffer: its pixels lie
// `ldy` elements apart (ldy == C for a tensor of its own). The dense-wired
// int8 forward (ops/quant.py `_dense_forward`) pools each block's output
// straight into its slot of the feature buffer this way, so no copy moves
// it there.
//
// Exactness: the max is exact, and in f32 a NaN wins as in ATen's
// max_pool2d. The quantize divides with __fdiv_rn (not a multiply by the
// reciprocal) and rounds half to even (__float2int_rn), as
// torch.round(torch.clamp(x / sx, -127, 127)) does, so every mode equals
// the plain PyTorch version bit for bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
enum Mode { kI8 = 0, kF32I8 = 1, kF32 = 2 };  // ops/pool.py FWD_MODES
enum Path { kVec16 = 0, kScalar = 1 };         // ops/pool.py FWD_PATHS

// The loaded vector and the stored one, and the elements they hold.
template <int MODE, bool VEC> struct Io;
template <> struct Io<kI8, true> { using In = int4; using Out = int4; static constexpr int N = 16; };
template <> struct Io<kI8, false> { using In = int8_t; using Out = int8_t; static constexpr int N = 1; };
template <> struct Io<kF32I8, true> { using In = float4; using Out = uint32_t; static constexpr int N = 4; };
template <> struct Io<kF32I8, false> { using In = float; using Out = int8_t; static constexpr int N = 1; };
template <> struct Io<kF32, true> { using In = float4; using Out = float4; static constexpr int N = 4; };
template <> struct Io<kF32, false> { using In = float; using Out = float; static constexpr int N = 1; };

// Max, letting a NaN win as ATen's max_pool2d does; 16 codes four at a time.
__device__ __forceinline__ float vmax(float a, float b) { return (b > a || b != b) ? b : a; }
__device__ __forceinline__ float4 vmax(float4 a, float4 b) {
  return make_float4(vmax(a.x, b.x), vmax(a.y, b.y), vmax(a.z, b.z), vmax(a.w, b.w));
}
__device__ __forceinline__ int8_t vmax(int8_t a, int8_t b) { return a > b ? a : b; }
__device__ __forceinline__ int4 vmax(int4 a, int4 b) {
  return make_int4(static_cast<int>(__vmaxs4(a.x, b.x)), static_cast<int>(__vmaxs4(a.y, b.y)),
                   static_cast<int>(__vmaxs4(a.z, b.z)), static_cast<int>(__vmaxs4(a.w, b.w)));
}

// The identity of vmax: what a row outside the image contributes.
template <typename T> __device__ __forceinline__ T lowest();
template <> __device__ __forceinline__ float lowest<float>() { return __int_as_float(static_cast<int>(0xff800000u)); }
template <> __device__ __forceinline__ float4 lowest<float4>() {
  const float v = lowest<float>();
  return make_float4(v, v, v, v);
}
template <> __device__ __forceinline__ int8_t lowest<int8_t>() { return -128; }
template <> __device__ __forceinline__ int4 lowest<int4>() {
  const int v = static_cast<int>(0x80808080u);
  return make_int4(v, v, v, v);
}

__device__ __forceinline__ uint32_t quant(float m, float sx) {
  const float v = fminf(fmaxf(__fdiv_rn(m, sx), -127.0f), 127.0f);
  return static_cast<uint8_t>(static_cast<int8_t>(__float2int_rn(v)));
}

template <int MODE, typename In, typename Out>
__device__ __forceinline__ void store(Out* p, In m, float sx) {
  if constexpr (MODE != kF32I8) {
    *p = m;
  } else if constexpr (sizeof(In) == 16) {
    *p = quant(m.x, sx) | quant(m.y, sx) << 8 | quant(m.z, sx) << 16 | quant(m.w, sx) << 24;
  } else {
    *p = static_cast<int8_t>(quant(m, sx));
  }
}

// One block: THREADS vectors of an image row, over a strip of `rows`
// output rows of one image. Vector i of a row is pixel i / nv; an output
// pixel is `ldv` vectors after the one before it.
template <int MODE, int WIN, bool VEC>
__global__ void __launch_bounds__(THREADS)
max_pool_s1_fwd(const typename Io<MODE, VEC>::In* __restrict__ x,
                typename Io<MODE, VEC>::Out* __restrict__ y, const float* __restrict__ scale,
                int H, int W, int nv, int ldv, int rows, int chunks, int strips) {
  using In = typename Io<MODE, VEC>::In;
  constexpr int LO = (WIN - 1) / 2, HI = WIN - 1 - LO;
  const int row_len = W * nv;
  const int chunk = blockIdx.x % chunks;
  const int strip = (blockIdx.x / chunks) % strips;
  const long long b = blockIdx.x / chunks / strips;
  const int i = chunk * THREADS + threadIdx.x;
  if (i >= row_len) return;
  const int w = i / nv;
  const int h0 = strip * rows;
  const int h1 = min(h0 + rows, H);
  const long long y_row = static_cast<long long>(W) * ldv;
  const In* xi = x + b * H * row_len + i;
  auto* yi = y + b * H * y_row + static_cast<long long>(w) * ldv + (i - w * nv);
  float sx = 0.0f;
  if constexpr (MODE == kF32I8) sx = __ldg(scale);

  // Input row r's max over the window's taps along W; lowest outside.
  auto row_max = [&](int r) {
    In m = lowest<In>();
    if (r >= 0 && r < H) {
      const In* p = xi + static_cast<long long>(r) * row_len;
#pragma unroll
      for (int d = -LO; d <= HI; ++d)
        if (w + d >= 0 && w + d < W) m = vmax(m, __ldg(p + d * nv));
    }
    return m;
  };
  In ring[WIN];  // row maxima of rows h - LO .. h + HI
#pragma unroll
  for (int k = 0; k < WIN - 1; ++k) ring[k] = row_max(h0 - LO + k);
  for (int h = h0; h < h1; ++h) {
    ring[WIN - 1] = row_max(h + HI);
    In m = ring[0];
#pragma unroll
    for (int k = 1; k < WIN; ++k) m = vmax(m, ring[k]);
    store<MODE>(yi + h * y_row, m, sx);
#pragma unroll
    for (int k = 0; k < WIN - 1; ++k) ring[k] = ring[k + 1];
  }
}

template <int MODE, int WIN, bool VEC>
int launch(const void* x, void* y, const float* scale, int B, int H, int W, int C, int ldy,
           int rows, cudaStream_t st) {
  using T = Io<MODE, VEC>;
  const int nv = C / T::N;
  const int chunks = (W * nv + THREADS - 1) / THREADS;
  const int strips = (H + rows - 1) / rows;
  const long long blocks = static_cast<long long>(chunks) * strips * B;
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  max_pool_s1_fwd<MODE, WIN, VEC><<<static_cast<unsigned>(blocks), THREADS, 0, st>>>(
      static_cast<const typename T::In*>(x), static_cast<typename T::Out*>(y), scale, H, W, nv,
      ldy / T::N, rows, chunks, strips);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE, bool VEC>
int launch_window(int window, const void* x, void* y, const float* scale, int B, int H, int W,
                  int C, int ldy, int rows, cudaStream_t st) {
  switch (window) {
    case 1: return launch<MODE, 1, VEC>(x, y, scale, B, H, W, C, ldy, rows, st);
    case 2: return launch<MODE, 2, VEC>(x, y, scale, B, H, W, C, ldy, rows, st);
    case 3: return launch<MODE, 3, VEC>(x, y, scale, B, H, W, C, ldy, rows, st);
    case 4: return launch<MODE, 4, VEC>(x, y, scale, B, H, W, C, ldy, rows, st);
    case 5: return launch<MODE, 5, VEC>(x, y, scale, B, H, W, C, ldy, rows, st);
    case 6: return launch<MODE, 6, VEC>(x, y, scale, B, H, W, C, ldy, rows, st);
    case 7: return launch<MODE, 7, VEC>(x, y, scale, B, H, W, C, ldy, rows, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int MODE>
int launch_mode(bool vec, int window, const void* x, void* y, const float* scale, int B, int H,
                int W, int C, int ldy, int rows, cudaStream_t st) {
  return vec ? launch_window<MODE, true>(window, x, y, scale, B, H, W, C, ldy, rows, st)
             : launch_window<MODE, false>(window, x, y, scale, B, H, W, C, ldy, rows, st);
}

}  // namespace

// y = maxpool_{window, SAME, stride 1}(x), x (B, H, W, C) NHWC-contiguous
// on the card and y (B, H, W, C) with its pixels `ldy` >= C elements apart
// (a channel slot of a wider NHWC buffer, or ldy == C), in `mode` (0 i8, 1
// f32_i8 with the float32 scale sx at `scale` on the card, 2 f32), over
// strips of `rows` output rows. `path` 0 (vec16) needs every input and
// output pixel in whole 16-byte loads on their boundaries: C and ldy in
// whole vectors, x on 16 bytes and y on its vector's size; 1 (scalar)
// takes any. Launches on `stream`, does not synchronise, and returns
// cudaGetLastError(), or cudaErrorInvalidValue for operands out of range.
extern "C" int dynseg_max_pool_s1(const void* x, void* y, const void* scale, int B, int H, int W,
                                  int C, int ldy, int window, int mode, int path, int rows,
                                  void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* sx = static_cast<const float*>(scale);
  const auto at = [](const void* p, unsigned n) { return reinterpret_cast<uintptr_t>(p) % n == 0; };
  if (B < 1 || H < 1 || W < 1 || C < 1 || ldy < C || rows < 1 || window < 1 || window > 7 ||
      static_cast<long long>(W) * C >= (1LL << 31) - THREADS ||
      (mode == kF32I8) != (sx != nullptr) || (path != kVec16 && path != kScalar))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = path == kVec16;
  // Codes per vector, and the bytes of its store.
  const int n = mode == kI8 ? 16 : 4, out_bytes = mode == kF32I8 ? 4 : 16;
  if (vec && (C % n || ldy % n || !at(x, 16) || !at(y, out_bytes)))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (mode) {
    case kI8: return launch_mode<kI8>(vec, window, x, y, sx, B, H, W, C, ldy, rows, st);
    case kF32I8: return launch_mode<kF32I8>(vec, window, x, y, sx, B, H, W, C, ldy, rows, st);
    case kF32: return launch_mode<kF32>(vec, window, x, y, sx, B, H, W, C, ldy, rows, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
