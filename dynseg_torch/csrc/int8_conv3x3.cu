// P1 for Hopper: the int8 conv probe's shifted-matmul kernel, on the
// tensor cores.
//
// Replaces the Pallas TPU kernel scripts/int8_kernel_probe.py
// (`_pallas_conv_kernel`, line 112, launched by `pallas_conv`, line 146).
// It computes a 3x3 dilated SAME conv of int8 NHWC activations with int8
// weights, C channels in and out, accumulated exactly in int32, then the
// probe's requant epilogue before the one int8 store:
//   q = int8(clip(rint(float32(acc) * scale), -128, 127)).
// The epilogue is not K5's: it rounds before it clips, and to -128.
//
// Formulation: an implicit GEMM, M = B*H*W output pixels, N = C output
// channels, K = 9 taps x C. A block of 8 warps computes a 128-pixel x
// 128-channel output tile; each warp a 64 x 32 sub-tile, as 4 x 4
// `mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32` products, with its 64
// int32 accumulators in registers. The K loop walks the 9 taps and, in
// each tap, C in chunks of 64 bytes. For each chunk, cp.async copies the
// shifted input rows and the packed weights (9, C out, C in) to shared
// memory, 16 bytes a thread; a source outside the image (the SAME border,
// pad = dilation on each side) or past C is copied with a source size of
// 0, which writes zeros. Both operands are K-major, as the fragments want
// them: A's row is a pixel and B's column an output channel, each with 32
// int8 values along K per m16n8k32 step. Shared rows are padded from 64 to
// 80 bytes so that the 32 lanes' 4-byte fragment loads hit 32 banks. Two
// stages: the next chunk's copies are in flight under the current
// chunk's products.
//
// What bounds it on the H100: the int8 operations (2 * 9 * C per output
// value, 4.6k at C = 256) against ~2 bytes moved per output value. mma.sync
// reaches only part of the tensor cores' 1,979 dense int8 TOPS; wgmma fed
// by TMA with a deeper pipeline is the way to the rest, and later work.
//
// Exactness: the accumulation is exact (|acc| <= 9 * C * 128^2 < 2^31);
// the epilogue converts with __int2float_rn, multiplies with __fmul_rn (no
// FMA contraction) and rounds half to even with rintf, as jnp.round and
// torch.round do, so the output equals the plain PyTorch version bit for
// bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;        // output pixels per block
constexpr int BN = 128;        // output channels per block
constexpr int BK = 64;         // K bytes (input channels of one tap) per stage
constexpr int LDS = BK + 16;   // padded shared row, bytes
constexpr int THREADS = 256;   // 8 warps: 2 along M x 4 along N

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = ok ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// d += a (16 x 32, row) * b (32 x 8, col), int8 in, int32 accumulate.
__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ signed char requant(int acc, float scale) {
  const float y = rintf(__fmul_rn(__int2float_rn(acc), scale));
  return static_cast<signed char>(
      static_cast<int>(fminf(fmaxf(y, -128.0f), 127.0f)));
}

__device__ __forceinline__ unsigned lds32(const int8_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

__global__ void __launch_bounds__(THREADS, 2)
int8_conv3x3_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                    int8_t* __restrict__ out, long long M, int H, int W, int C,
                    int dil, float scale) {
  __shared__ __align__(16) int8_t As[2][BM * LDS];
  __shared__ __align__(16) int8_t Bs[2][BN * LDS];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const int wm = (warp & 1) * 64;
  const int wn = (warp >> 1) * 32;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;

  // Loader role: rows lr and lr + 64 of both tiles (pixels of A, output
  // channels of B), the 16-byte piece lp of the 64-byte K chunk.
  const int lr = tid >> 2;
  const int lp = (tid & 3) * 16;
  int pb[2], ph[2], pw[2];
  bool pok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long m = m0 + lr + 64 * i;
    pok[i] = m < M;
    const long long mm = pok[i] ? m : 0;
    pw[i] = static_cast<int>(mm % W);
    const long long q = mm / W;
    ph[i] = static_cast<int>(q % H);
    pb[i] = static_cast<int>(q / H);
  }

  const int chunks = (C + BK - 1) / BK;
  const int steps = 9 * chunks;

  auto load = [&](int step, int stage) {
    const int tap = step / chunks;
    const int c = (step - tap * chunks) * BK + lp;
    const int dr = (tap / 3 - 1) * dil;
    const int dc = (tap % 3 - 1) * dil;
    const bool c_ok = c < C;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = lr + 64 * i;
      const int hi = ph[i] + dr;
      const int wi = pw[i] + dc;
      const bool ok = pok[i] && c_ok && hi >= 0 && hi < H && wi >= 0 && wi < W;
      const int8_t* src =
          ok ? x + ((static_cast<long long>(pb[i]) * H + hi) * W + wi) *
                       static_cast<long long>(C) + c
             : x;
      cp_async16(&As[stage][row * LDS + lp], src, ok);
      const int n = n0 + row;
      const bool ok_b = c_ok && n < C;
      const int8_t* src_b =
          ok_b ? w + (static_cast<long long>(tap) * C + n) * C + c : w;
      cp_async16(&Bs[stage][row * LDS + lp], src_b, ok_b);
    }
    cp_async_commit();
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  load(0, 0);
  for (int step = 0; step < steps; ++step) {
    const int stage = step & 1;
    if (step + 1 < steps) {
      load(step + 1, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int8_t* a_s = As[stage];
    const int8_t* b_s = Bs[stage];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      unsigned af[4][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        // a0: row g, K bytes 4t..4t+3; a1: row g+8; a2, a3: K + 16.
        const int8_t* p = a_s + (wm + mi * 16 + g) * LDS + kk + t * 4;
        af[mi][0] = lds32(p);
        af[mi][1] = lds32(p + 8 * LDS);
        af[mi][2] = lds32(p + 16);
        af[mi][3] = lds32(p + 8 * LDS + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        // b0: column g, K bytes 4t..4t+3; b1: K + 16.
        const int8_t* p = b_s + (wn + ni * 8 + g) * LDS + kk + t * 4;
        bf[ni][0] = lds32(p);
        bf[ni][1] = lds32(p + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
    }
    __syncthreads();
  }

  // d0, d1: row g, columns 2t, 2t+1; d2, d3: row g+8.
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int n = n0 + wn + ni * 8 + t * 2;
      if (n >= C) continue;  // C is even, so n + 1 < C as well
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long m = m0 + wm + mi * 16 + g + half * 8;
        if (m >= M) continue;
        char2 v;
        v.x = requant(acc[mi][ni][half * 2], scale);
        v.y = requant(acc[mi][ni][half * 2 + 1], scale);
        *reinterpret_cast<char2*>(out + m * C + n) = v;
      }
    }
  }
}

}  // namespace

// x (B,H,W,C) int8 NHWC; w (9, C out, C in) int8; out (B,H,W,C) int8; all
// contiguous, C % 32 == 0. Launches on `stream`, does not synchronise, and
// returns cudaGetLastError().
extern "C" int dynseg_int8_conv3x3(const void* x, const void* w, void* out,
                                   int B, int H, int W, int C, int dil,
                                   float scale, void* stream) {
  const long long M = static_cast<long long>(B) * H * W;
  const dim3 grid(static_cast<unsigned>((M + BM - 1) / BM),
                  static_cast<unsigned>((C + BN - 1) / BN));
  int8_conv3x3_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<int8_t*>(out), M, H, W, C, dil, scale);
  return static_cast<int>(cudaGetLastError());
}
