// What the kernels that copy by TMA share: the stage barriers (mbarrier)
// with a wait that traps instead of hanging, the arm-and-copy
// instructions, and the driver's tensor-map encoders, reached through
// the runtime (cudaGetDriverEntryPoint) so that the library links no
// libcuda. Used by int8_block_conv.cu (K5) and pool_bwd.cu (K4).
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

}  // namespace tma
}  // namespace
