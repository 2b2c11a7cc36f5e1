// K7 for Hopper: the int8 activation quantize of a float map.
//
// Replaces none in Pallas: the reference quantizes an activation with
// jnp.round(jnp.clip(x / sx, -127, 127)).astype(int8) in dynseg/ops/quant.py,
// which XLA fuses into one pass. The port ran it as ATen's composition
// torch.round(torch.clamp(x.float() / sx, -127, 127)).to(torch.int8): a
// divide, a clamp and a round that each read and write float32, then a
// cast, 21 bytes a value. The dense-wired net quantizes its whole concat
// prefix (144 to 656 channels) at every int8 block, so that composition
// took about a quarter of its forward.
//
// One launch writes y = rint(clamp(x / sx, -127, 127)) as int8 codes for a
// float32 or bfloat16 map x of `pixels` pixels of C channels each. The
// channels of a pixel are contiguous; pixel p starts `pixel_stride` elements
// after pixel p - 1, so x may be the channel prefix of a wider buffer (the
// dense forward's feature buffer) and is read in place. y is (pixels, C)
// contiguous. sx is one float32 on the card.
//
// What bounds it on the H100: bytes, 4 (bfloat16: 2) read and 1 written a
// value; a divide a value is far under any compute rate. The dense-wired
// net's four prefixes at 8 x 336^2 (1,472 channels a pixel) move 6.65 GB,
// 1.98 ms at 3.35 TB/s.
//
// Design: on the "vec16" path a thread owns 16 channels of one pixel: four
// 16-byte loads of float32 (two of bfloat16) and one 16-byte store of the
// codes. Neighbouring threads take neighbouring 16-channel pieces of a
// pixel, then those of the next pixel, so a warp reads and writes whole
// lines. A grid of a few blocks an SM strides over the pieces. A C that is
// not whole 16-channel pieces, or a base or pixel stride off 16 bytes,
// takes the "scalar" path: the same kernel with one value a thread. The
// wrapper (ops/pool.py `quantize_path`) chooses the path.
//
// Exactness: bfloat16 widens to float32 exactly; the quantize divides with
// __fdiv_rn (not a multiply by the reciprocal), clamps, and rounds half to
// even (__float2int_rn), as torch.round(torch.clamp(x / sx, -127, 127))
// does, so the codes equal the plain PyTorch version's bit for bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 8;
enum Path { kVec16 = 0, kScalar = 1 };  // ops/pool.py QUANT_PATHS

__device__ __forceinline__ uint32_t code(float v, float sx) {
  const float q = fminf(fmaxf(__fdiv_rn(v, sx), -127.0f), 127.0f);
  return static_cast<uint8_t>(static_cast<int8_t>(__float2int_rn(q)));
}

__device__ __forceinline__ uint32_t pack4(float a, float b, float c, float d, float sx) {
  return code(a, sx) | code(b, sx) << 8 | code(c, sx) << 16 | code(d, sx) << 24;
}

// bfloat16 bits to float32: the high half of a float32, exact. A 32-bit
// word holds element 2k in its low half and 2k + 1 in its high half.
__device__ __forceinline__ float lo16(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi16(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

// The 16 codes of the 16 values at p (16-byte aligned).
template <bool BF16>
__device__ __forceinline__ uint4 quant16(const char* p, float sx) {
  if constexpr (BF16) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
    const uint4 b = __ldg(reinterpret_cast<const uint4*>(p) + 1);
    return make_uint4(pack4(lo16(a.x), hi16(a.x), lo16(a.y), hi16(a.y), sx),
                      pack4(lo16(a.z), hi16(a.z), lo16(a.w), hi16(a.w), sx),
                      pack4(lo16(b.x), hi16(b.x), lo16(b.y), hi16(b.y), sx),
                      pack4(lo16(b.z), hi16(b.z), lo16(b.w), hi16(b.w), sx));
  } else {
    const float4* q = reinterpret_cast<const float4*>(p);
    const float4 a = __ldg(q), b = __ldg(q + 1), c = __ldg(q + 2), d = __ldg(q + 3);
    return make_uint4(pack4(a.x, a.y, a.z, a.w, sx), pack4(b.x, b.y, b.z, b.w, sx),
                      pack4(c.x, c.y, c.z, c.w, sx), pack4(d.x, d.y, d.z, d.w, sx));
  }
}

// Item i is a 16-channel piece (VEC) or one value; `per_pixel` items make
// a pixel, `n` items the map. Pixel strides are in bytes.
template <bool BF16, bool VEC>
__global__ void __launch_bounds__(THREADS)
quantize_s8_fwd(const char* __restrict__ x, int8_t* __restrict__ y,
                const float* __restrict__ scale, long long n, int per_pixel,
                long long stride_bytes) {
  constexpr int ELEM = BF16 ? 2 : 4;
  const float sx = __ldg(scale);
  for (long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * THREADS) {
    const long long p = i / per_pixel;
    const int k = static_cast<int>(i - p * per_pixel);
    const char* src = x + p * stride_bytes;
    if constexpr (VEC) {
      reinterpret_cast<uint4*>(y)[i] = quant16<BF16>(src + k * 16 * ELEM, sx);
    } else {
      const float v = BF16 ? lo16(reinterpret_cast<const uint16_t*>(src)[k])
                           : reinterpret_cast<const float*>(src)[k];
      y[i] = static_cast<int8_t>(code(v, sx));
    }
  }
}

template <bool BF16, bool VEC>
int launch(const void* x, void* y, const float* sx, long long n, int per_pixel,
           long long stride_bytes, cudaStream_t st) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long want = (n + THREADS - 1) / THREADS;
  const long long most = static_cast<long long>(sms) * BLOCKS_PER_SM;
  const unsigned blocks = static_cast<unsigned>(want < most ? want : most);
  quantize_s8_fwd<BF16, VEC><<<blocks, THREADS, 0, st>>>(
      static_cast<const char*>(x), static_cast<int8_t*>(y), sx, n, per_pixel, stride_bytes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y = rint(clamp(x / sx, -127, 127)) as int8: x `pixels` pixels of C
// float32 (bf16 = 0) or bfloat16 (bf16 = 1) channels, pixel p at element
// p * pixel_stride; y (pixels, C) contiguous; sx at `scale`, one float32 on
// the card. `path` 0 (vec16) needs C a multiple of 16 and x, y and the
// pixel stride on 16 bytes; 1 (scalar) takes any. Launches on `stream`,
// does not synchronise, and returns cudaGetLastError(), or
// cudaErrorInvalidValue for operands out of range.
extern "C" int dynseg_quantize_s8(const void* x, void* y, const void* scale, long long pixels,
                                  int C, long long pixel_stride, int bf16, int path,
                                  void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* sx = static_cast<const float*>(scale);
  const int elem = bf16 ? 2 : 4;
  const auto at16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (pixels < 1 || C < 1 || pixel_stride < 0 || sx == nullptr || (bf16 != 0 && bf16 != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long stride_bytes = pixel_stride * elem;
  switch (path) {
    case kVec16:
      if (C % 16 || !at16(x) || !at16(y) || stride_bytes % 16)
        return static_cast<int>(cudaErrorInvalidValue);
      return bf16 ? launch<true, true>(x, y, sx, pixels * (C / 16), C / 16, stride_bytes, st)
                  : launch<false, true>(x, y, sx, pixels * (C / 16), C / 16, stride_bytes, st);
    case kScalar:
      return bf16 ? launch<true, false>(x, y, sx, pixels * C, C, stride_bytes, st)
                  : launch<false, false>(x, y, sx, pixels * C, C, stride_bytes, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
