// What the kernels that copy by TMA share: the stage barriers (mbarrier)
// with a wait that traps instead of hanging, the arm-and-copy
// instructions, libcuda's tensor-map encoders, reached through the
// runtime (cudaGetDriverEntryPoint) so that the library links no libcuda,
// and, for the int8 convolutions, the wgmma descriptor of a 128-byte-
// swizzled operand and the maps of their two operands. Used by
// int8_block_conv.cu (K5), int8_conv3x3.cu (P1) and pool_bwd.cu (K4).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <cudaTypedefs.h>  // CUtensorMap and the driver's function types

namespace {
namespace tma {

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

// Makes the barriers' initialisation visible to the copy engine; call
// once after mbar_init, before the block's barrier (__syncthreads).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
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

// One thread: this phase of the barrier completes when `bytes` have
// arrived (and the one expected arrival, this one, has happened).
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes) : "memory");
}

// One thread (or warp lane): one arrival on the barrier, no bytes.
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// One thread: the box of a 3-D tiled tensor map at (c0, c1, c2) into
// shared memory at `dst`, counted on `bar`.
__device__ __forceinline__ void load_tile_3d(uint32_t dst, const CUtensorMap* map, int c0,
                                             int c1, int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// One thread: the map's pixels-per-column consecutive output pixels of an
// NHWC tensor by TMA in im2col mode, each a row of the map's channels
// from channel c. The walk starts at pixel (n, h, w) (the output pixel
// shifted by -pad_lo) and adds the tap's offset (dx, dy); outside the
// image reads as zero, which is the SAME border.
__device__ __forceinline__ void load_im2col_4d(uint32_t dst, const CUtensorMap* map, int c,
                                               int w, int h, int n, uint16_t dx, uint16_t dy,
                                               uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6], {%7, %8};\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(w), "r"(h), "r"(n), "r"(bar),
      "h"(dx), "h"(dy)
      : "memory");
}

// Shared-memory matrix descriptor of a K-major wgmma operand in the
// 128-byte swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

// One thread: the box of a 4-D tiled tensor map at (c0, c1, c2, c3)
// (signed; elements outside the tensor take the map's fill) into shared
// memory at `dst`, counted on `bar`.
__device__ __forceinline__ void load_tile_4d(uint32_t dst, const CUtensorMap* map, int c0,
                                             int c1, int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// The driver function `name`, looked up once per process.
template <typename Fn>
cudaError_t driver_fn(const char* name, Fn* fn) {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult found;
  const cudaError_t e = cudaGetDriverEntryPoint(name, &p, cudaEnableDefault, &found);
  if (e != cudaSuccess) return e;
  if (found != cudaDriverEntryPointSuccess || p == nullptr) return cudaErrorNotSupported;
  *fn = reinterpret_cast<Fn>(p);
  return cudaSuccess;
}

inline cudaError_t encode_tiled(PFN_cuTensorMapEncodeTiled_v12000* fn) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    const cudaError_t e = driver_fn("cuTensorMapEncodeTiled", &encode);
    if (e != cudaSuccess) return e;
  }
  *fn = encode;
  return cudaSuccess;
}

inline cudaError_t encode_im2col(PFN_cuTensorMapEncodeIm2col_v12000* fn) {
  static PFN_cuTensorMapEncodeIm2col_v12000 encode = nullptr;
  if (encode == nullptr) {
    const cudaError_t e = driver_fn("cuTensorMapEncodeIm2col", &encode);
    if (e != cudaSuccess) return e;
  }
  *fn = encode;
  return cudaSuccess;
}

// Packed conv weights (taps, Cout, Cin) int8 as a 3-D tiled map: boxes of
// box_k Cin bytes x box_n output channels of one tap, 128-byte swizzled;
// Cin and Cout past the tensor read as zeros.
inline cudaError_t weight_map(CUtensorMap* map, const void* w, int Cin, int Cout, int taps,
                              int box_k, int box_n) {
  PFN_cuTensorMapEncodeTiled_v12000 encode;
  const cudaError_t e = encode_tiled(&encode);
  if (e != cudaSuccess) return e;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(Cin), static_cast<cuuint64_t>(Cout),
                              static_cast<cuuint64_t>(taps)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(Cin),
                                 static_cast<cuuint64_t>(Cin) * Cout};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_k), static_cast<cuuint32_t>(box_n),
                             1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(w),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// An int8 NHWC input (B, H, W, Cin) as a 4-D im2col map: `pixels` pixels
// of box_k Cin bytes a load, 128-byte swizzled, walked over the output
// pixels shifted by -pad_lo (pad_lo < 128, the range of the corners).
inline cudaError_t input_map(CUtensorMap* map, const void* x, int B, int H, int W, int Cin,
                             int pad_lo, int box_k, int pixels) {
  PFN_cuTensorMapEncodeIm2col_v12000 encode;
  const cudaError_t e = encode_im2col(&encode);
  if (e != cudaSuccess) return e;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(Cin), static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(Cin),
                                 static_cast<cuuint64_t>(Cin) * W,
                                 static_cast<cuuint64_t>(Cin) * W * H};
  const int lower[2] = {-pad_lo, -pad_lo};
  const int upper[2] = {-pad_lo, -pad_lo};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(x),
                            dims, strides, lower, upper, static_cast<cuuint32_t>(box_k),
                            static_cast<cuuint32_t>(pixels), unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace tma
}  // namespace
