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
// K = k*k*Cin. Both operands are K-major: A's row is a pixel of the NHWC
// input shifted by the tap, B's row an output channel of the weights packed
// as (k*k, Cout, Cin). The K loop walks the k*k taps and, in each tap, Cin
// in chunks. Outside the image (the SAME border: pad_lo = ((k-1)*d)/2, the
// extra pixel of an even k after) and past Cin or Cout the operands are
// zero, which adds nothing to the sum.
//
// Two variants, chosen by the wrapper from the shape (ops/int8_conv.py):
//
//  * wgmma (Cin % 16 == 0, Cout % 16 == 0 and pad_lo < 128; every serving
//    block): the tensor cores through `wgmma.mma_async.m64n128k32.s32.s8.s8`.
//    A block of two warpgroups computes a 128-pixel x 128-channel tile, each
//    warpgroup 64 pixel rows with 64 int32 accumulators a thread. K advances
//    128 bytes (Cin values of one tap) a stage. One thread copies a stage by
//    TMA, both operands into 128-byte-swizzled shared memory, the layout the
//    wgmma descriptors read: B as a box of a 3-D tiled tensor map of the
//    weights, A in im2col mode, which walks 128 consecutive output pixels
//    shifted by the tap and reads zeros outside the image (the SAME border
//    with no bounds checks in the kernel). The stage's mbarrier counts the
//    bytes. Three stages (96 KB, two blocks an SM): the copies of the next
//    two stages are in flight under the current stage's products. The
//    epilogue stages the tile in shared memory and stores 16 bytes a
//    thread, so a row of the output is written whole.
//  * dp4a (any Cin and Cout, such as the dense-wired net's concat inputs of
//    131 channels): the first version, __dp4a on the integer pipes with an
//    8 x 8 accumulator tile a thread.
//
// What bounds it on the H100: the int8 operations. The serving blocks are
// 2*k*k*Cin operations per output value (2.3k-4.6k) against 1-5 bytes
// moved, far above the card's ~590 operations a byte, so the tensor cores'
// 1,979 dense int8 TOPS set the bound (PERF.md has each variant's share).
//
// Exactness: the accumulation is exact in every variant; the epilogue uses
// __fmul_rn and __fadd_rn so that no multiply-add is contracted into an
// FMA, and rintf (round half to even, as jnp.round and torch.round) for the
// requant, so the output equals the plain PyTorch version bit for bit.

#include <cstdint>
#include <cuda_runtime.h>
#include <cudaTypedefs.h>  // CUtensorMap and the driver's function types

namespace {

__device__ __forceinline__ float epilogue(int acc, float a, float b,
                                          float leaky) {
  float y = __fadd_rn(__fmul_rn(__int2float_rn(acc), a), b);
  return y >= 0.0f ? y : __fmul_rn(y, leaky);
}

__device__ __forceinline__ signed char requant(float y, float inv_scale) {
  const float t = fminf(fmaxf(__fmul_rn(y, inv_scale), -127.0f), 127.0f);
  return static_cast<signed char>(static_cast<int>(rintf(t)));
}

// ---------------------------------------------------------------------------
// wgmma variant.
namespace tc {

constexpr int BM = 128;                     // output pixels per block
constexpr int BN = 128;                     // output channels per block
constexpr int BK = 128;                     // K bytes per stage
constexpr int STAGES = 3;
constexpr int PREFETCH = STAGES - 1;        // stages copied ahead
constexpr int THREADS = 256;                // two warpgroups
constexpr int A_BYTES = BM * BK;
constexpr int B_BYTES = BN * BK;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int BAR_OFFSET = STAGES * STAGE_BYTES;   // one barrier a stage
constexpr int SMEM_BYTES = BAR_OFFSET + 8 * STAGES + 1024;  // + alignment
constexpr int LDC_F32 = BN + 8;             // staged f32 row, floats
constexpr int LDC_S8 = BN + 16;             // staged int8 row, bytes

// Shared-memory matrix descriptor of a K-major operand in the 128-byte
// swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous products.
__device__ __forceinline__ void fence_operands(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (64 x 128, int32, in the accumulator fragment) += A (64 x 32) * B^T.
__device__ __forceinline__ void wgmma_m64n128k32(int (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

// Wait until the barrier's phase of this parity has completed. A wait that
// has not ended after 2^26 polls traps, so a fault ends the kernel with an
// error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (long long spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (spin > (1ll << 26)) __trap();
  }
}

// One thread: arm the stage's barrier for `bytes`, then copy the weight
// box (128 Cin bytes x 128 output channels of one tap) at (c, n, tap) by TMA
// into 128-byte-swizzled shared memory; Cin or Cout past the tensor read as
// zero.
__device__ __forceinline__ void tma_load_b(uint32_t dst, const CUtensorMap* map, int c,
                                           int n, int tap, uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(n), "r"(tap), "r"(bar)
      : "memory");
}

// One thread: 128 consecutive output pixels' input rows (128 Cin bytes
// each) by TMA in im2col mode. The walk starts at output pixel (n, h, w)
// shifted by -pad_lo and adds the tap's offset (dx, dy) = (kx*d, ky*d);
// outside the image reads as zero, which is the SAME border.
__device__ __forceinline__ void tma_load_a(uint32_t dst, const CUtensorMap* map, int c,
                                           int w, int h, int n, uint16_t dx, uint16_t dy,
                                           uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6], {%7, %8};\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(w), "r"(h), "r"(n), "r"(bar),
      "h"(dx), "h"(dy)
      : "memory");
}

template <bool REQUANT>
__global__ void __launch_bounds__(THREADS, 2)
k5_wgmma_kernel(const __grid_constant__ CUtensorMap wmap,
                const __grid_constant__ CUtensorMap xmap,
                const float* __restrict__ aff_a, const float* __restrict__ aff_b,
                void* __restrict__ out, long long M, int H, int W, int Cin, int Cout,
                int k, int dil, int pad_lo, float leaky, float inv_scale) {
  extern __shared__ uint8_t smem_raw[];
  // The swizzle pattern repeats every 1024 bytes of shared address.
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
  uint8_t* smem = smem_raw + pad;
  const uint32_t sbase = raw + pad;
  const uint32_t bar0 = sbase + BAR_OFFSET;

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(bar0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // The tile's first output pixel, where the im2col walk starts.
  const int n_px = static_cast<int>(m0 / (static_cast<long long>(H) * W));
  const int h_px = static_cast<int>((m0 / W) % H);
  const int w_px = static_cast<int>(m0 % W);
  const int chunks = (Cin + BK - 1) / BK;
  const int steps = k * k * chunks;

  // Thread 0 copies a stage: A and B of one tap and one 128-byte Cin chunk.
  auto load = [&](int step, int stage) {
    const int tap = step / chunks;
    const int c0 = (step - tap * chunks) * BK;
    const uint32_t sa = sbase + stage * STAGE_BYTES;
    const uint32_t bar = bar0 + 8 * stage;
    tma_load_b(sa + A_BYTES, &wmap, c0, n0, tap, bar, STAGE_BYTES);
    tma_load_a(sa, &xmap, c0, w_px - pad_lo, h_px - pad_lo, n_px,
               static_cast<uint16_t>((tap % k) * dil), static_cast<uint16_t>((tap / k) * dil),
               bar);
  };

  int acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;

  __syncthreads();  // the barriers are initialised
  if (tid == 0) {
    for (int s = 0; s < PREFETCH && s < steps; ++s) load(s, s);
  }
  for (int step = 0; step < steps; ++step) {
    // Every warpgroup's products of step - 1 are done (waited below), so
    // that stage can be refilled while this one is multiplied.
    __syncthreads();
    const int nxt = step + PREFETCH;
    if (tid == 0 && nxt < steps) load(nxt, nxt % STAGES);
    const int stage = step % STAGES;
    mbar_wait(bar0 + 8 * stage, static_cast<uint32_t>((step / STAGES) & 1));
    const uint32_t sa = sbase + stage * STAGE_BYTES;
    const uint64_t da = sw128_desc(sa + wg * 64 * BK);
    const uint64_t db = sw128_desc(sa + A_BYTES);
    fence_operands(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) {
      // +32 bytes of K: +2 in the descriptor's 16-byte address units.
      wgmma_m64n128k32(acc, da + 2 * kk, db + 2 * kk);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_operands(acc);
  }
  __syncthreads();  // the stages are free: stage the output tile there

  // Accumulator fragment: register 4j + 2h + e holds row
  // wg*64 + warp*16 + lane/4 + 8h, column 8j + 2*(lane%4) + e.
  const int lane = tid & 31;
  const int row0 = wg * 64 + ((tid & 127) >> 5) * 16 + (lane >> 2);
  const int colq = (lane & 3) * 2;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = j * 8 + colq;
    const int n = n0 + col;
    const bool ok = n < Cout;  // Cout is even: n + 1 < Cout as well
    const float a0 = ok ? aff_a[n] : 0.0f, a1 = ok ? aff_a[n + 1] : 0.0f;
    const float b0 = ok ? aff_b[n] : 0.0f, b1 = ok ? aff_b[n + 1] : 0.0f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + 8 * h;
      const float y0 = epilogue(acc[4 * j + 2 * h], a0, b0, leaky);
      const float y1 = epilogue(acc[4 * j + 2 * h + 1], a1, b1, leaky);
      if (REQUANT) {
        char2 q;
        q.x = requant(y0, inv_scale);
        q.y = requant(y1, inv_scale);
        *reinterpret_cast<char2*>(smem + r * LDC_S8 + col) = q;
      } else {
        *reinterpret_cast<float2*>(reinterpret_cast<float*>(smem) +
                                   r * LDC_F32 + col) = make_float2(y0, y1);
      }
    }
  }
  __syncthreads();

  // 16-byte stores; Cout % 16 == 0 keeps every piece inside or outside.
  if (REQUANT) {
    int8_t* o = static_cast<int8_t*>(out);
#pragma unroll
    for (int i = 0; i < BM * BN / 16 / THREADS; ++i) {
      const int p = tid + THREADS * i;
      const int r = p >> 3;
      const int c = (p & 7) * 16;
      const long long m = m0 + r;
      if (m < M && n0 + c < Cout) {
        *reinterpret_cast<int4*>(o + m * Cout + n0 + c) =
            *reinterpret_cast<const int4*>(smem + r * LDC_S8 + c);
      }
    }
  } else {
    float* o = static_cast<float*>(out);
    const float* cs = reinterpret_cast<const float*>(smem);
#pragma unroll 4
    for (int i = 0; i < BM * BN / 4 / THREADS; ++i) {
      const int p = tid + THREADS * i;
      const int r = p >> 5;
      const int c = (p & 31) * 4;
      const long long m = m0 + r;
      if (m < M && n0 + c < Cout) {
        *reinterpret_cast<float4*>(o + m * Cout + n0 + c) =
            *reinterpret_cast<const float4*>(cs + r * LDC_F32 + c);
      }
    }
  }
}

// The weights (k*k, Cout, Cin) as a 3-D TMA tensor map: boxes of 128 Cin
// bytes x 128 output channels of one tap, 128-byte swizzled; Cin and Cout
// past the tensor read as zeros. cuTensorMapEncodeTiled is the driver's,
// reached through the runtime so that the library links no libcuda.
cudaError_t weight_map(CUtensorMap* map, const void* w, int Cin, int Cout, int taps) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (e != cudaSuccess) return e;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(Cin), static_cast<cuuint64_t>(Cout),
                              static_cast<cuuint64_t>(taps)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(Cin),
                                 static_cast<cuuint64_t>(Cin) * Cout};
  const cuuint32_t box[3] = {BK, BN, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(w),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The input (B, H, W, Cin) as a 4-D im2col TMA map: 128 pixels of 128 Cin
// bytes a load, walked over the output pixels shifted by -pad_lo.
cudaError_t input_map(CUtensorMap* map, const void* x, int B, int H, int W, int Cin,
                      int pad_lo) {
  static PFN_cuTensorMapEncodeIm2col_v12000 encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeIm2col", &fn, cudaEnableDefault, &found);
    if (e != cudaSuccess) return e;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeIm2col_v12000>(fn);
  }
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(Cin), static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(Cin),
                                 static_cast<cuuint64_t>(Cin) * W,
                                 static_cast<cuuint64_t>(Cin) * W * H};
  const int lower[2] = {-pad_lo, -pad_lo};
  const int upper[2] = {-pad_lo, -pad_lo};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(x),
                            dims, strides, lower, upper, BK, BM, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace tc

// ---------------------------------------------------------------------------
// dp4a variant: any Cin and Cout.
namespace dp {

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

// ALIGNED: Cin % 16 == 0 and Cout % 4 == 0 (16-byte loads, 4-channel
// stores); otherwise any Cin and Cout, with byte loads and single stores.
template <bool REQUANT, bool ALIGNED>
__global__ void __launch_bounds__(THREADS, 2)
k5_dp4a_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
               const float* __restrict__ aff_a,
               const float* __restrict__ aff_b, void* __restrict__ out,
               long long M, int H, int W, int Cin, int Cout, int k, int dil,
               int pad_lo, float leaky, float inv_scale) {
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

}  // namespace dp

using Kernel = void (*)(const int8_t*, const int8_t*, const float*,
                        const float*, void*, long long, int, int, int, int,
                        int, int, int, float, float);

}  // namespace

// x (B,H,W,Cin) int8 NHWC; w (k*k, Cout, Cin) int8; a, b (Cout) f32;
// out (B,H,W,Cout) int8 when requant, else f32; all contiguous, x and w
// 16-byte aligned. variant: 0 dp4a (any Cin, Cout), 1 wgmma (Cin % 16 ==
// 0, Cout % 16 == 0, pad_lo < 128). Launches on `stream`, does not
// synchronise, and returns cudaGetLastError(), or cudaErrorInvalidValue
// for a shape the variant does not take.
extern "C" int dynseg_int8_block_conv(const void* x, const void* w,
                                      const void* a, const void* b, void* out,
                                      int B, int H, int W, int Cin, int Cout,
                                      int k, int dil, int pad_lo, float leaky,
                                      int requant, float inv_scale,
                                      int variant, void* stream) {
  const long long M = static_cast<long long>(B) * H * W;
  const auto s = static_cast<cudaStream_t>(stream);
  const bool tile16 = Cin % 16 == 0 && Cout % 16 == 0;
  Kernel fn = nullptr;
  int threads = 0, smem = 0, bm = 0, bn = 0;
  if (variant == 1 && tile16) {
    static bool ready[2] = {false, false};
    auto* kernel = requant ? &tc::k5_wgmma_kernel<true> : &tc::k5_wgmma_kernel<false>;
    if (!ready[requant ? 1 : 0]) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, tc::SMEM_BYTES);
      if (e != cudaSuccess) return static_cast<int>(e);
      ready[requant ? 1 : 0] = true;
    }
    CUtensorMap wmap, xmap;
    cudaError_t e = tc::weight_map(&wmap, w, Cin, Cout, k * k);
    if (e == cudaSuccess) e = tc::input_map(&xmap, x, B, H, W, Cin, pad_lo);
    if (e != cudaSuccess) return static_cast<int>(e);
    const dim3 grid(static_cast<unsigned>((M + tc::BM - 1) / tc::BM),
                    static_cast<unsigned>((Cout + tc::BN - 1) / tc::BN));
    kernel<<<grid, tc::THREADS, tc::SMEM_BYTES, s>>>(
        wmap, xmap, static_cast<const float*>(a), static_cast<const float*>(b), out, M,
        H, W, Cin, Cout, k, dil, pad_lo, leaky, inv_scale);
    return static_cast<int>(cudaGetLastError());
  } else if (variant == 0) {
    const bool aligned = Cin % 16 == 0 && Cout % 4 == 0;
    fn = requant ? (aligned ? &dp::k5_dp4a_kernel<true, true>
                            : &dp::k5_dp4a_kernel<true, false>)
                 : (aligned ? &dp::k5_dp4a_kernel<false, true>
                            : &dp::k5_dp4a_kernel<false, false>);
    threads = dp::THREADS, bm = dp::BM, bn = dp::BN;
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>((M + bm - 1) / bm),
                  static_cast<unsigned>((Cout + bn - 1) / bn));
  fn<<<grid, threads, smem, s>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(a), static_cast<const float*>(b), out, M, H, W,
      Cin, Cout, k, dil, pad_lo, leaky, inv_scale);
  return static_cast<int>(cudaGetLastError());
}
