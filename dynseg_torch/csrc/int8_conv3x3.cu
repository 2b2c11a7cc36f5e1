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
// channels, K = 9 taps x C. Both operands are K-major: A's row is a pixel
// of the NHWC input shifted by the tap (pad = dilation on each side), B's
// row an output channel of the weights packed as (9, C out, C in).
//
// What bounds it on the H100: the int8 operations (2 * 9 * C per output
// value, 4.6k at C = 256) against ~2 bytes moved per output value, far
// above the card's ~590 operations a byte: the tensor cores' 1,979 dense
// int8 TOPS set the bound. Two variants, chosen by the wrapper from the
// shape and the pointers (ops/int8_probe_conv.py `variant_for`):
//
//  * wgmma (a 16-byte-aligned input and a dilation under 128, the range of
//    TMA's im2col corners): warp-specialised, for the tensor cores'
//    full rate. A block of three warpgroups: one producer warp copies by
//    TMA, two consumer warpgroups multiply. A block tile is 128 pixels by
//    BN = 256 output channels (128 for C <= 128), so each activation row
//    leaves L2 once per tap and N block, and at C = 256 once per tap.
//    A stage is one tap's 128 Cin bytes: A (128 pixels) in im2col mode,
//    whose zero fill is the SAME border, and B (BN channels) as a box of a
//    3-D tiled map, whose zero fill covers C past the tensor (C = 160);
//    both 128-byte swizzled, the layout the wgmma descriptors read. A ring
//    of four stages with a full and an empty mbarrier each: the producer
//    arms a stage's full barrier with its bytes once the consumers have
//    released it; a consumer warpgroup waits on the full barrier, issues
//    four `wgmma.mma_async.m64nBNk32.s32.s8.s8` on its 64 rows, keeps that
//    group in flight (`wgmma.wait_group 1`) while the next stage's are
//    issued, and releases a stage (one arrival a warp) once its products
//    are done. No block-wide barrier in the main loop. `setmaxnreg` gives
//    the consumers 232 registers a thread for the 128 int32 accumulators
//    of m64n256 and the producer 40. The epilogue requantizes in
//    registers, stages each warpgroup's 64 x BN int8 tile in shared memory
//    (16-byte chunks XOR-swizzled by row, so neither side conflicts) and
//    writes whole rows with 16-byte stores. The grid is persistent: one
//    block an SM walks the tiles, so the producer fills the next tile's
//    stages under the current tile's epilogue.
//  * mma_sync (the first kernel; any base pointer): `mma.sync.m16n8k32` s8 on
//    a 128 x 128 tile, cp.async double buffer of 64-byte K chunks; an input
//    off 16-byte alignment is read a byte at a time instead.
//
// Exactness: the accumulation is exact (|acc| <= 9 * C * 128^2 < 2^31);
// the epilogue converts with __int2float_rn, multiplies with __fmul_rn (no
// FMA contraction) and rounds half to even with rintf, as jnp.round and
// torch.round do, so the output equals the plain PyTorch version bit for
// bit.

#include <cstdint>
#include <cuda_runtime.h>

#include "tma.cuh"  // stage barriers, TMA copies, descriptors, tensor maps

namespace {

__device__ __forceinline__ signed char requant(int acc, float scale) {
  const float y = rintf(__fmul_rn(__int2float_rn(acc), scale));
  return static_cast<signed char>(
      static_cast<int>(fminf(fmaxf(y, -128.0f), 127.0f)));
}

// ---------------------------------------------------------------------------
// mma_sync variant.
namespace ms {

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

__device__ __forceinline__ unsigned lds32(const int8_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// 16 input bytes at p, zero where !ok, read a byte at a time (p may be off
// 16-byte alignment), then stored to shared memory as one vector.
__device__ __forceinline__ void copy16_bytes(void* smem, const int8_t* p, bool ok) {
  int v[4] = {0, 0, 0, 0};
  if (ok) {
#pragma unroll
    for (int i = 0; i < 16; ++i)
      v[i >> 2] |= static_cast<int>(static_cast<uint8_t>(p[i])) << (8 * (i & 3));
  }
  *reinterpret_cast<int4*>(smem) = make_int4(v[0], v[1], v[2], v[3]);
}

// ALIGNED: x is 16-byte aligned and its rows are copied by cp.async;
// otherwise they are read a byte at a time.
template <bool ALIGNED>
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
      if (ALIGNED) {
        cp_async16(&As[stage][row * LDS + lp], src, ok);
      } else {
        copy16_bytes(&As[stage][row * LDS + lp], src, ok);
      }
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

}  // namespace ms

// ---------------------------------------------------------------------------
// wgmma variant.
namespace wg {

constexpr int BM = 128;        // output pixels per block tile
constexpr int BK = 128;        // K bytes per stage: one tap's 128 Cin bytes
constexpr int STAGES = 4;
constexpr int THREADS = 384;   // producer warpgroup + two consumer warpgroups
constexpr int CONSUMER_WARPS = 8;
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;

// Shared memory of a block: the stages (A then B), the two warpgroups'
// staged output tiles, the full and the empty barriers.
template <int BN>
struct Layout {
  static constexpr int A_BYTES = BM * BK;
  static constexpr int STAGE_BYTES = A_BYTES + BN * BK;
  static constexpr int OUT = STAGES * STAGE_BYTES;
  static constexpr int BAR = OUT + BM * BN;
  static constexpr int BYTES = BAR + 16 * STAGES + 1024;  // + alignment
};

// d (64 x 128, int32, in the accumulator fragment) += A (64 x 32) * B^T.
__device__ __forceinline__ void wgmma_n128(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, %64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 256, int32, in the accumulator fragment) += A (64 x 32) * B^T.
__device__ __forceinline__ void wgmma_n256(int (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, "
      "%109, %110, %111, %112, %113, %114, %115, %116, %117, %118, "
      "%119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
        "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]),
        "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]),
        "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]),
        "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]), "+r"(d[120]),
        "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]),
        "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous products.
template <int R>
__device__ __forceinline__ void fence_operands(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

template <int BN>
__device__ __forceinline__ void mma_stage(int (&d)[BN / 2], uint64_t da, uint64_t db) {
#pragma unroll
  for (int kk = 0; kk < BK / 32; ++kk) {
    // +32 bytes of K: +2 in the descriptor's 16-byte address units.
    if constexpr (BN == 256) {
      wgmma_n256(d, da + 2 * kk, db + 2 * kk);
    } else {
      wgmma_n128(d, da + 2 * kk, db + 2 * kk);
    }
  }
}

// Named barrier of one consumer warpgroup's 128 threads.
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
p1_wgmma_kernel(const __grid_constant__ CUtensorMap wmap,
                const __grid_constant__ CUtensorMap xmap, int8_t* __restrict__ out,
                long long M, int H, int W, int C, int dil, float scale, int m_tiles,
                int n_tiles) {
  using L = Layout<BN>;
  extern __shared__ uint8_t smem_raw[];
  // The swizzle pattern repeats every 1024 bytes of shared address.
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
  uint8_t* smem = smem_raw + pad;
  const uint32_t sbase = raw + pad;
  const uint32_t full0 = sbase + L::BAR;
  const uint32_t empty0 = full0 + 8 * STAGES;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      tma::mbar_init(full0 + 8 * s, 1);
      tma::mbar_init(empty0 + 8 * s, CONSUMER_WARPS);
    }
    tma::fence_barrier_init();
  }
  __syncthreads();  // the only block-wide barrier
  const int tiles = m_tiles * n_tiles;
  const int chunks = (C + BK - 1) / BK;
  const int steps = 9 * chunks;

  if (tid < 128) {
    // Producer warpgroup: one thread issues every copy.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (tid == 0) {
      int it = 0;  // stages filled so far, over all of this block's tiles
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const long long m0 = static_cast<long long>(tile / n_tiles) * BM;
        const int n0 = (tile % n_tiles) * BN;
        // The tile's first output pixel, where the im2col walk starts.
        const int n_px = static_cast<int>(m0 / (static_cast<long long>(H) * W));
        const int h_px = static_cast<int>((m0 / W) % H);
        const int w_px = static_cast<int>(m0 % W);
        for (int step = 0; step < steps; ++step, ++it) {
          const int stage = it % STAGES;
          // The consumers have released the stage's previous use (the first
          // use of each stage passes at once).
          tma::mbar_wait(empty0 + 8 * stage, static_cast<uint32_t>(((it / STAGES) & 1) ^ 1));
          const int tap = step / chunks;
          const int c0 = (step - tap * chunks) * BK;
          const uint32_t sa = sbase + stage * L::STAGE_BYTES;
          const uint32_t bar = full0 + 8 * stage;
          tma::mbar_expect_tx(bar, L::STAGE_BYTES);
          tma::load_tile_3d(sa + L::A_BYTES, &wmap, c0, n0, tap, bar);
          tma::load_im2col_4d(sa, &xmap, c0, w_px - dil, h_px - dil, n_px,
                              static_cast<uint16_t>((tap % 3) * dil),
                              static_cast<uint16_t>((tap / 3) * dil), bar);
        }
      }
    }
  } else {
    // Consumer warpgroups: rows 64 * cw .. 64 * cw + 63 of each tile.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int cw = (tid >> 7) - 1;
    const int ctid = tid & 127;
    const int lane = tid & 31;
    uint8_t* tile_out = smem + L::OUT + cw * 64 * BN;
    int it = 0;  // stages consumed so far
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const long long m0 = static_cast<long long>(tile / n_tiles) * BM;
      const int n0 = (tile % n_tiles) * BN;
      int acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
      for (int step = 0; step < steps; ++step, ++it) {
        const int stage = it % STAGES;
        tma::mbar_wait(full0 + 8 * stage, static_cast<uint32_t>((it / STAGES) & 1));
        const uint32_t sa = sbase + stage * L::STAGE_BYTES;
        fence_operands(acc);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
        mma_stage<BN>(acc, tma::sw128_desc(sa + cw * 64 * BK),
                      tma::sw128_desc(sa + L::A_BYTES));
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        // This stage's products stay in flight; the previous stage's are
        // done, so that stage goes back to the producer.
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        fence_operands(acc);
        if (step > 0 && lane == 0) tma::mbar_arrive(empty0 + 8 * ((it - 1) % STAGES));
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_operands(acc);
      if (lane == 0) tma::mbar_arrive(empty0 + 8 * ((it - 1) % STAGES));

      // Accumulator fragment: register 4j + 2h + e holds row
      // warp*16 + lane/4 + 8h of the warpgroup's 64, column 8j + 2*(lane%4) + e.
      // Staged row r keeps its 16-byte chunk k at chunk k ^ (r % 8).
      warpgroup_sync(1 + cw);  // the previous tile's rows are stored
      const int row0 = ((ctid >> 5) << 4) + (lane >> 2);
      const int colq = (lane & 3) * 2;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row0 + 8 * h;
          const int col = j * 8 + colq;
          char2 q;
          q.x = requant(acc[4 * j + 2 * h], scale);
          q.y = requant(acc[4 * j + 2 * h + 1], scale);
          *reinterpret_cast<char2*>(tile_out + r * BN + (((col >> 4) ^ (r & 7)) << 4) +
                                    (col & 15)) = q;
        }
      }
      warpgroup_sync(1 + cw);
      // Whole rows, 16 bytes a thread; C % 32 == 0 keeps every chunk inside
      // or outside the tensor.
#pragma unroll
      for (int i = 0; i < 64 * BN / 16 / 128; ++i) {
        const int p = ctid + 128 * i;
        const int r = p / (BN / 16);
        const int k = p % (BN / 16);
        const long long m = m0 + cw * 64 + r;
        const int n = n0 + k * 16;
        if (m < M && n < C) {
          *reinterpret_cast<int4*>(out + m * C + n) =
              *reinterpret_cast<const int4*>(tile_out + r * BN + ((k ^ (r & 7)) << 4));
        }
      }
    }
  }
}

// Launches the BN-wide kernel on a persistent grid of one block an SM (at
// most one a tile). Refuses a build whose register count the producer's
// setmaxnreg.dec cannot pay the consumers' setmaxnreg.inc from, which would
// block the consumers for good.
template <int BN>
cudaError_t launch(const void* x, const void* w, void* out, int B, int H, int W, int C,
                   int dil, float scale, cudaStream_t stream) {
  using L = Layout<BN>;
  auto* kernel = &p1_wgmma_kernel<BN>;
  static int ready = 0;  // 1: attributes set and registers checked
  if (!ready) {
    cudaFuncAttributes attr;
    cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
    if (e != cudaSuccess) return e;
    if (2 * (CONSUMER_REGS - attr.numRegs) > attr.numRegs - PRODUCER_REGS) {
      return cudaErrorInvalidConfiguration;
    }
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    if (e != cudaSuccess) return e;
    ready = 1;
  }
  CUtensorMap wmap, xmap;
  cudaError_t e = tma::weight_map(&wmap, w, C, C, 9, BK, BN);
  if (e == cudaSuccess) e = tma::input_map(&xmap, x, B, H, W, C, dil, BK, BM);
  if (e != cudaSuccess) return e;
  const long long M = static_cast<long long>(B) * H * W;
  const int m_tiles = static_cast<int>((M + BM - 1) / BM);
  const int n_tiles = (C + BN - 1) / BN;
  int device = 0, sms = 0;
  e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  const int grid = m_tiles * n_tiles < sms ? m_tiles * n_tiles : sms;
  kernel<<<grid, THREADS, L::BYTES, stream>>>(wmap, xmap, static_cast<int8_t*>(out), M, H, W,
                                              C, dil, scale, m_tiles, n_tiles);
  return cudaGetLastError();
}

}  // namespace wg

}  // namespace

// x (B,H,W,C) int8 NHWC; w (9, C out, C in) int8; out (B,H,W,C) int8; all
// contiguous, C % 32 == 0; w and out 16-byte aligned. variant: 0 mma_sync
// (any x), 1 wgmma (x 16-byte aligned, dil < 128). Launches on `stream`,
// does not synchronise, and returns cudaGetLastError(), or
// cudaErrorInvalidValue for a shape or pointer the variant does not take.
extern "C" int dynseg_int8_conv3x3(const void* x, const void* w, void* out,
                                   int B, int H, int W, int C, int dil,
                                   float scale, int variant, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (variant == 1) {
    const uintptr_t ptrs = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
                           reinterpret_cast<uintptr_t>(out);
    if (ptrs % 16 || dil >= 128 || C % 32) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(C <= 128
        ? wg::launch<128>(x, w, out, B, H, W, C, dil, scale, s)
        : wg::launch<256>(x, w, out, B, H, W, C, dil, scale, s));
  }
  if (variant != 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long M = static_cast<long long>(B) * H * W;
  const dim3 grid(static_cast<unsigned>((M + ms::BM - 1) / ms::BM),
                  static_cast<unsigned>((C + ms::BN - 1) / ms::BN));
  auto* kernel = reinterpret_cast<uintptr_t>(x) % 16 ? &ms::int8_conv3x3_kernel<false>
                                                     : &ms::int8_conv3x3_kernel<true>;
  kernel<<<grid, ms::THREADS, 0, s>>>(static_cast<const int8_t*>(x),
                                      static_cast<const int8_t*>(w),
                                      static_cast<int8_t*>(out), M, H, W, C, dil, scale);
  return static_cast<int>(cudaGetLastError());
}
