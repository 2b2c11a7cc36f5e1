// K5 for Hopper: the int8 block conv of the int8 serving path.
//
// Replaces the Pallas TPU kernel dynseg/ops/pallas_conv.py (`_kernel`,
// line 59, launched by `int8_block_conv`, line 103). It computes one
// quantized conv block in a single launch: a k x k dilated SAME conv of
// int8 NHWC activations with int8 weights, accumulated exactly in int32,
// then the block's whole epilogue before the one store:
//   y = A*acc + B  (dequant sx*sw_c folded with BN or the conv bias),
//   leaky-ReLU, and, for the streamed-int8 chain, the requant
//   q = int8(rint(clip(y * (1/out_scale), -127, 127))).
//
// Formulation: an implicit GEMM, M = B*H*W output pixels, N = Cout,
// K = k*k*Cin. A block computes a 128-pixel x 128-channel output tile;
// its K loop walks the k*k taps and, inside each tap, Cin in chunks of 64.
// For every chunk it stages the shifted input rows (zero outside the image,
// which is the SAME padding: pad_lo = ((k-1)*d)/2, the extra pixel after)
// and the packed weights (k*k, Cout, Cin) in shared memory. Both operands
// are contiguous along Cin, so with Cin % 16 == 0 every global load is 16
// bytes (other Cin and Cout, such as the dense-wired net's concat inputs,
// take a variant with byte loads and single stores). Each of the
// 256 threads keeps an 8 x 8 int32 accumulator tile in registers and adds
// 4 int8 products per __dp4a. The next chunk's global loads are issued
// before the current chunk's math, so they are in flight under it.
//
// What bounds it on the H100: the int8 operations. The blocks it serves
// are 2*k*k*Cin integer ops per output value (4.6k for 256->256 k3), far
// above the bytes it moves, and __dp4a runs on the SM's integer pipes,
// well below the tensor cores' 1,979 dense int8 TOPS. Moving the inner
// product to mma.sync / wgmma s8 fed by TMA is later work; this version is
// the simple, exact one.
//
// Exactness: the accumulation is exact; the epilogue uses __fmul_rn and
// __fadd_rn so that no multiply-add is contracted into an FMA, and rintf
// (round half to even, as jnp.round and torch.round) for the requant, so
// the int8 output equals the plain PyTorch version bit for bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;      // output pixels per block
constexpr int BN = 128;      // output channels per block
constexpr int BKW = 16;      // K depth of one stage, in 32-bit words (64 Cin)
constexpr int THREADS = 256;

// 16 int8 values from p, zero where !ok and past the first `valid`. With
// ALIGNED (Cin % 16 == 0), p is 16-byte aligned and `valid` is <= 0 or
// >= 16, so one vector load does; otherwise the bytes are packed one by
// one, little-endian as __dp4a reads them.
template <bool ALIGNED>
__device__ __forceinline__ int4 load16(const int8_t* p, bool ok, int valid) {
  if (ALIGNED) {
    return ok && valid > 0 ? *reinterpret_cast<const int4*>(p)
                           : make_int4(0, 0, 0, 0);
  }
  int v[4] = {0, 0, 0, 0};
  if (ok) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      if (i < valid) {
        v[i >> 2] |= static_cast<int>(static_cast<uint8_t>(p[i])) << (8 * (i & 3));
      }
    }
  }
  return make_int4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ float epilogue(int acc, float a, float b,
                                          float leaky) {
  float y = __fadd_rn(__fmul_rn(__int2float_rn(acc), a), b);
  return y >= 0.0f ? y : __fmul_rn(y, leaky);
}

__device__ __forceinline__ signed char requant(float y, float inv_scale) {
  const float t = fminf(fmaxf(__fmul_rn(y, inv_scale), -127.0f), 127.0f);
  return static_cast<signed char>(static_cast<int>(rintf(t)));
}

// ALIGNED: Cin % 16 == 0 and Cout % 4 == 0 (16-byte loads, 4-channel
// stores); otherwise any Cin and Cout, with byte loads and single stores.
template <bool REQUANT, bool ALIGNED>
__global__ void __launch_bounds__(THREADS, 2)
int8_block_conv_kernel(const int8_t* __restrict__ x,
                       const int8_t* __restrict__ w,
                       const float* __restrict__ aff_a,
                       const float* __restrict__ aff_b,
                       void* __restrict__ out, long long M, int H, int W,
                       int Cin, int Cout, int k, int dil, int pad_lo,
                       float leaky, float inv_scale) {
  // [K word][row]: a thread's four consecutive rows are one 16-byte read.
  __shared__ __align__(16) int As[BKW][BM];
  __shared__ __align__(16) int Bs[BKW][BN];

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // output channels n0 + {0,64} + tx*4 + 0..3
  const int ty = tid >> 4;  // output pixels  m0 + {0,64} + ty*4 + 0..3
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;

  // Loader role: row lr of both tiles (a pixel of A, a channel of B),
  // eight K words from word lq.
  const int lr = tid >> 1;
  const int lq = (tid & 1) * 8;
  const long long am = m0 + lr;
  const bool a_ok = am < M;
  int ab = 0, ah = 0, aw = 0;
  if (a_ok) {
    aw = static_cast<int>(am % W);
    const long long t = am / W;
    ah = static_cast<int>(t % H);
    ab = static_cast<int>(t / H);
  }
  const int bn = n0 + lr;
  const bool b_ok = bn < Cout;

  const int chunks = (Cin + 4 * BKW - 1) / (4 * BKW);
  const int steps = k * k * chunks;

  int4 ra[2], rb[2];
  auto fetch = [&](int step) {
    const int tap = step / chunks;
    const int c0 = (step - tap * chunks) * (4 * BKW) + lq * 4;
    const int hi = ah + (tap / k) * dil - pad_lo;
    const int wi = aw + (tap % k) * dil - pad_lo;
    const bool in = a_ok && hi >= 0 && hi < H && wi >= 0 && wi < W;
    const int8_t* pa = x + ((static_cast<long long>(ab) * H + hi) * W + wi) *
                               static_cast<long long>(Cin) + c0;
    const int8_t* pb = w + (static_cast<long long>(tap) * Cout + bn) * Cin + c0;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int valid = Cin - (c0 + 16 * q);
      ra[q] = load16<ALIGNED>(pa + 16 * q, in, valid);
      rb[q] = load16<ALIGNED>(pb + 16 * q, b_ok, valid);
    }
  };

  int acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0;

  fetch(0);
  for (int step = 0; step < steps; ++step) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int r = lq + 4 * q;
      As[r + 0][lr] = ra[q].x;
      As[r + 1][lr] = ra[q].y;
      As[r + 2][lr] = ra[q].z;
      As[r + 3][lr] = ra[q].w;
      Bs[r + 0][lr] = rb[q].x;
      Bs[r + 1][lr] = rb[q].y;
      Bs[r + 2][lr] = rb[q].z;
      Bs[r + 3][lr] = rb[q].w;
    }
    __syncthreads();
    if (step + 1 < steps) fetch(step + 1);
#pragma unroll
    for (int kw = 0; kw < BKW; ++kw) {
      const int4 a0 = *reinterpret_cast<const int4*>(&As[kw][ty * 4]);
      const int4 a1 = *reinterpret_cast<const int4*>(&As[kw][64 + ty * 4]);
      const int4 b0 = *reinterpret_cast<const int4*>(&Bs[kw][tx * 4]);
      const int4 b1 = *reinterpret_cast<const int4*>(&Bs[kw][64 + tx * 4]);
      const int av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const int bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (m >= M) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n = n0 + half * 64 + tx * 4;
      if (n >= Cout) continue;
      const long long o = m * Cout + n;
      if (!ALIGNED) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (n + j >= Cout) break;
          const float y = epilogue(acc[i][half * 4 + j], aff_a[n + j],
                                   aff_b[n + j], leaky);
          if (REQUANT) {
            static_cast<int8_t*>(out)[o + j] = requant(y, inv_scale);
          } else {
            static_cast<float*>(out)[o + j] = y;
          }
        }
        continue;
      }
      float y[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        y[j] = epilogue(acc[i][half * 4 + j], aff_a[n + j], aff_b[n + j], leaky);
      if (REQUANT) {
        char4 q;
        q.x = requant(y[0], inv_scale);
        q.y = requant(y[1], inv_scale);
        q.z = requant(y[2], inv_scale);
        q.w = requant(y[3], inv_scale);
        *reinterpret_cast<char4*>(static_cast<int8_t*>(out) + o) = q;
      } else {
        *reinterpret_cast<float4*>(static_cast<float*>(out) + o) =
            make_float4(y[0], y[1], y[2], y[3]);
      }
    }
  }
}

}  // namespace

template <bool REQUANT, bool ALIGNED>
void launch(const dim3& grid, cudaStream_t s, const int8_t* x,
            const int8_t* w, const float* a, const float* b, void* out,
            long long M, int H, int W, int Cin, int Cout, int k, int dil,
            int pad_lo, float leaky, float inv_scale) {
  int8_block_conv_kernel<REQUANT, ALIGNED><<<grid, THREADS, 0, s>>>(
      x, w, a, b, out, M, H, W, Cin, Cout, k, dil, pad_lo, leaky, inv_scale);
}

// x (B,H,W,Cin) int8 NHWC; w (k*k, Cout, Cin) int8; a, b (Cout) f32;
// out (B,H,W,Cout) int8 when requant, else f32; all contiguous. Launches
// on `stream`, does not synchronise, and returns cudaGetLastError().
extern "C" int dynseg_int8_block_conv(const void* x, const void* w,
                                      const void* a, const void* b, void* out,
                                      int B, int H, int W, int Cin, int Cout,
                                      int k, int dil, int pad_lo, float leaky,
                                      int requant, float inv_scale,
                                      void* stream) {
  const long long M = static_cast<long long>(B) * H * W;
  const dim3 grid(static_cast<unsigned>((M + BM - 1) / BM),
                  static_cast<unsigned>((Cout + BN - 1) / BN));
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* wp = static_cast<const int8_t*>(w);
  const auto* ap = static_cast<const float*>(a);
  const auto* bp = static_cast<const float*>(b);
  const bool aligned = Cin % 16 == 0 && Cout % 4 == 0;
  auto* fn = requant ? (aligned ? &launch<true, true> : &launch<true, false>)
                     : (aligned ? &launch<false, true> : &launch<false, false>);
  fn(grid, s, xp, wp, ap, bp, out, M, H, W, Cin, Cout, k, dil, pad_lo, leaky,
     inv_scale);
  return static_cast<int>(cudaGetLastError());
}
