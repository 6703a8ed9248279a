// Blockwise symmetric int8 quantize / dequantize for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/quant8/kernel.py::_quant_kernel   (quantize_blocks)
//   src/repro/kernels/quant8/kernel.py::_dequant_kernel (dequantize_blocks)
// Same function: x of N elements viewed as (rows, block), rows =
// ceil(N / block); per row scale = amax / 127 (1 where amax == 0) in fp32,
// q = clip(round_half_even(x / scale), -127, 127) as int8; dequantize is
// float(q) * scale[row] cast to the output dtype.  Elements past N (the
// ragged tail of the last row) are read as 0 inside the kernel, so the
// caller never builds a padded copy of its input; q still has the padded
// length rows * block, as the TPU function returned it.
//
// The codes and scales are bit-exact with the plain versions and with the
// JAX package's kernel as XLA compiles it: the scale is amax times the
// fp32 reciprocal of 127 (XLA rewrites the division by the constant 127
// into that product, and a true division differs from it in the last bit
// of ~4 % of the scales), x / scale is an IEEE division (no reciprocal
// multiply, no fast math), rounding is rintf (half to even, as jnp.round
// and torch.round), and the clamp is symmetric at +-127.
//
// What bounds it on an H100: device memory.  Per element quantize reads
// 4 (fp32) or 2 (bf16) bytes and writes 1, plus 4 bytes of scale per row;
// it does a handful of fp32 operations, far below the card's ridge.  At
// opt-1.3b's largest leaf (402,653,184 fp32 elements, block 256) each
// kernel moves 2.020 GB: at least 0.603 ms at 3.35 TB/s.  Neither kernel
// uses the tensor cores.
//
// Design (simple first):
//  * quantize: one warp per row, rows walked grid-stride; each lane owns
//    block/32 consecutive elements, read with 16-byte (or, for bf16 at
//    block 128, 8-byte) vector loads and written back as one packed vector
//    of codes; the row's amax is a warp-shuffle max reduction.  A partial
//    last row takes guarded scalar loads.  The TPU kernel tiled 256 rows
//    per grid step and had to fall back to a plain function for row counts
//    the tile did not divide; the grid-stride loop takes any row count.
//  * dequantize: each thread turns 16 codes (one 16-byte load; block is a
//    multiple of 128, so they share one row and one scale) into 16 outputs
//    written as 16-byte vectors, grid-stride over the padded length.
// Left for later: more than one row in flight per warp, and fusing the
// round trip (quantize -> dequantize -> error feedback) into one pass.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Copies of N bytes through the widest vector the size allows (N is 4, 8,
// 16, 32 or 64 here, every address aligned to min(N, 16)).
template <int N>
__device__ __forceinline__ void copy_bytes(void* dst, const void* src) {
  if constexpr (N % 16 == 0) {
#pragma unroll
    for (int i = 0; i < N / 16; ++i)
      reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
  } else if constexpr (N == 8) {
    *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
  } else {
    static_assert(N == 4, "unsupported vector size");
    *reinterpret_cast<uint32_t*>(dst) =
        *reinterpret_cast<const uint32_t*>(src);
  }
}

template <typename T, int BLOCK>
__global__ void __launch_bounds__(kThreads) quant8_quantize_kernel(
    const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ s,
    long long n, long long rows) {
  constexpr int EPL = BLOCK / 32;  // elements per lane
  const int lane = threadIdx.x & 31;
  const long long warp = (static_cast<long long>(blockIdx.x) * kThreads +
                          threadIdx.x) >> 5;
  const long long nwarps =
      (static_cast<long long>(gridDim.x) * kThreads) >> 5;
  for (long long row = warp; row < rows; row += nwarps) {
    const long long base = row * BLOCK + static_cast<long long>(lane) * EPL;
    float v[EPL];
    if ((row + 1) * BLOCK <= n) {
      alignas(16) T raw[EPL];
      copy_bytes<static_cast<int>(EPL * sizeof(T))>(raw, x + base);
#pragma unroll
      for (int i = 0; i < EPL; ++i) v[i] = to_float(raw[i]);
    } else {  // the ragged last row: past n reads as 0
#pragma unroll
      for (int i = 0; i < EPL; ++i)
        v[i] = base + i < n ? to_float(x[base + i]) : 0.0f;
    }
    float amax = 0.0f;
#pragma unroll
    for (int i = 0; i < EPL; ++i) amax = fmaxf(amax, fabsf(v[i]));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    const float scale = amax > 0.0f ? amax * (1.0f / 127.0f) : 1.0f;
    alignas(16) int8_t codes[EPL];
#pragma unroll
    for (int i = 0; i < EPL; ++i) {
      const float r = rintf(v[i] / scale);
      codes[i] = static_cast<int8_t>(fminf(fmaxf(r, -127.0f), 127.0f));
    }
    copy_bytes<EPL>(q + base, codes);
    if (lane == 0) s[row] = scale;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) quant8_dequantize_kernel(
    const int8_t* __restrict__ q, const float* __restrict__ s,
    T* __restrict__ out, long long chunks, int block) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long c = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       c < chunks; c += stride) {
    const long long base = c * 16;
    alignas(16) int8_t codes[16];
    copy_bytes<16>(codes, q + base);
    const float scale = s[base / block];
    alignas(16) T vals[16];
#pragma unroll
    for (int i = 0; i < 16; ++i)
      vals[i] = from_float<T>(static_cast<float>(codes[i]) * scale);
    copy_bytes<static_cast<int>(16 * sizeof(T))>(out + base, vals);
  }
}

int grid_for(long long work) {
  const long long blocks = (work + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < kMaxBlocks ? (blocks > 0 ? blocks : 1)
                                              : kMaxBlocks);
}

template <typename T>
int quantize_as(const void* x, int8_t* q, float* s, long long n,
                long long rows, int block, cudaStream_t stream) {
  const int grid = grid_for(rows * 32);
  switch (block) {
    case 128:
      quant8_quantize_kernel<T, 128><<<grid, kThreads, 0, stream>>>(
          static_cast<const T*>(x), q, s, n, rows);
      break;
    case 256:
      quant8_quantize_kernel<T, 256><<<grid, kThreads, 0, stream>>>(
          static_cast<const T*>(x), q, s, n, rows);
      break;
    case 512:
      quant8_quantize_kernel<T, 512><<<grid, kThreads, 0, stream>>>(
          static_cast<const T*>(x), q, s, n, rows);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: n elements, fp32 (dtype 0) or bf16 (dtype 1); q: rows * block int8;
// s: rows fp32; rows = ceil(n / block); block 128, 256 or 512.
extern "C" int quant8_quantize_launch(const void* x, void* q, void* s,
                                      long long n, long long rows, int block,
                                      int dtype, void* stream) {
  if (rows <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* qp = static_cast<int8_t*>(q);
  float* sp = static_cast<float*>(s);
  switch (dtype) {
    case 0:
      return quantize_as<float>(x, qp, sp, n, rows, block, st);
    case 1:
      return quantize_as<__nv_bfloat16>(x, qp, sp, n, rows, block, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// q: rows * block int8; s: rows fp32; out: rows * block, fp32 (dtype 0)
// or bf16 (dtype 1); block a multiple of 16 (128, 256 or 512 here).
extern "C" int quant8_dequantize_launch(const void* q, const void* s,
                                        void* out, long long rows, int block,
                                        int dtype, void* stream) {
  if (rows <= 0) return 0;
  if (block % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long chunks = rows * block / 16;
  const int grid = grid_for(chunks);
  const int8_t* qp = static_cast<const int8_t*>(q);
  const float* sp = static_cast<const float*>(s);
  switch (dtype) {
    case 0:
      quant8_dequantize_kernel<float><<<grid, kThreads, 0, st>>>(
          qp, sp, static_cast<float*>(out), chunks, block);
      break;
    case 1:
      quant8_dequantize_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
          qp, sp, static_cast<__nv_bfloat16*>(out), chunks, block);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
