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
// uses the tensor cores.  Dequantize moves 80 % of its bytes as writes,
// so how its stores reach memory sets its pace: a warp store instruction
// that covers half of each of 32 sectors (16 bytes a lane, lanes 64 bytes
// apart) ran it at 1.3 TB/s, against 2.7 TB/s with each instruction
// writing 512 contiguous bytes (PERF.md has the runs).
//
// Design:
//  * quantize: one warp per row, rows walked grid-stride; each lane owns
//    block/32 consecutive elements, read with 16-byte (or, for bf16 at
//    block 128, 8-byte) vector loads and written back as one packed vector
//    of codes; the row's amax is a warp-shuffle max reduction.  A partial
//    last row takes guarded scalar loads.  The TPU kernel tiled 256 rows
//    per grid step and had to fall back to a plain function for row counts
//    the tile did not divide; the grid-stride loop takes any row count.
//  * dequantize: warp-contiguous 16-byte streaming stores, several runs a
//    warp in flight, one wave of blocks sized from the SM count (see the
//    kernel).  A bulk-copy pipeline through shared memory (cp.async.bulk
//    in and out) ran no faster on the card, so the simpler loop was kept.
// Left for later: more than one row in flight per quantize warp, and
// fusing the round trip (quantize -> dequantize -> error feedback) into
// one pass.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // quantize's grid cap
constexpr int kDeqRuns = 4;           // dequantize's runs a warp trip

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
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

// Dequantize: warp-contiguous stores.  A lane converts V codes (V = 4 for
// fp32 output, 8 for bf16) into 16 output bytes, and lane l of a warp
// takes codes [run + V l, run + V l + V) of a run of 32 V codes, so one
// warp store instruction writes 512 contiguous bytes and one warp load
// reads 32 V contiguous codes.  A warp takes kDeqRuns runs a trip and
// issues all their loads before its first store.  Codes and scales are
// read through the read-only path (ld.global.nc), the output written with
// the streaming hint (st.global.cs): it is too large to stay in the L2.
// BLOCK is a multiple of 16, so a lane's V codes lie in one row and take
// one scale (at bf16 and block 128 a run's halves take two rows' scales).
// n = rows * BLOCK is a multiple of V, so a lane's V codes lie wholly
// before n or wholly past it.
__device__ __forceinline__ float code_at(uint32_t word, int i) {
  return static_cast<float>(static_cast<int8_t>(word >> (8 * i)));
}

// a in the low half, b in the high half (memory order a, b)
__device__ __forceinline__ uint32_t bf16_pair(float a, float b) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(a))) |
         static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(b)))
             << 16;
}

// 4 codes -> 4 fp32, one 16-byte streaming store
__device__ __forceinline__ void dequant16(uint32_t w, float scale,
                                          float* out) {
  __stcs(reinterpret_cast<float4*>(out),
         make_float4(code_at(w, 0) * scale, code_at(w, 1) * scale,
                     code_at(w, 2) * scale, code_at(w, 3) * scale));
}

// 8 codes -> 8 bf16, one 16-byte streaming store; each value is the fp32
// product rounded once, to nearest even
__device__ __forceinline__ void dequant16(uint2 w, float scale,
                                          __nv_bfloat16* out) {
  uint4 v;
  v.x = bf16_pair(code_at(w.x, 0) * scale, code_at(w.x, 1) * scale);
  v.y = bf16_pair(code_at(w.x, 2) * scale, code_at(w.x, 3) * scale);
  v.z = bf16_pair(code_at(w.y, 0) * scale, code_at(w.y, 1) * scale);
  v.w = bf16_pair(code_at(w.y, 2) * scale, code_at(w.y, 3) * scale);
  __stcs(reinterpret_cast<uint4*>(out), v);
}

template <typename T, int BLOCK>
__global__ void __launch_bounds__(kThreads) quant8_dequantize_kernel(
    const int8_t* __restrict__ q, const float* __restrict__ s,
    T* __restrict__ out, long long n) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  constexpr long long kRun = 32LL * V;
  using Codes = std::conditional_t<V == 4, uint32_t, uint2>;
  const int lane = threadIdx.x & 31;
  const long long warp = (static_cast<long long>(blockIdx.x) * kThreads +
                          threadIdx.x) >> 5;
  const long long stride =
      ((static_cast<long long>(gridDim.x) * kThreads) >> 5) * kRun * kDeqRuns;
  for (long long base = warp * kRun * kDeqRuns + lane * V; base < n;
       base += stride) {
    Codes c[kDeqRuns];
    float scale[kDeqRuns];
#pragma unroll
    for (int r = 0; r < kDeqRuns; ++r) {
      const long long at = base + r * kRun;
      if (at < n) {
        c[r] = __ldg(reinterpret_cast<const Codes*>(q + at));
        scale[r] = __ldg(s + at / BLOCK);
      }
    }
#pragma unroll
    for (int r = 0; r < kDeqRuns; ++r) {
      const long long at = base + r * kRun;
      if (at < n) dequant16(c[r], scale[r], out + at);
    }
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

// One wave: as many blocks as are resident on all SMs at once (the card's
// SM count times the kernel's occupancy), fewer when the runs fill fewer,
// so a leaf of 2,048 codes launches one block.
template <typename T, int BLOCK>
int dequantize_with(const int8_t* q, const float* s, void* out, long long n,
                    cudaStream_t stream) {
  const auto kernel = quant8_dequantize_kernel<T, BLOCK>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  constexpr long long kBlockCodes = (kThreads / 32) * kDeqRuns * 32LL *
                                    (16 / static_cast<int>(sizeof(T)));
  const long long want = (n + kBlockCodes - 1) / kBlockCodes;
  const long long wave =
      static_cast<long long>(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  const int grid = static_cast<int>(want < wave ? want : wave);
  kernel<<<grid, kThreads, 0, stream>>>(q, s, static_cast<T*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dequantize_as(const int8_t* q, const float* s, void* out, long long n,
                  int block, cudaStream_t stream) {
  switch (block) {
    case 128:
      return dequantize_with<T, 128>(q, s, out, n, stream);
    case 256:
      return dequantize_with<T, 256>(q, s, out, n, stream);
    case 512:
      return dequantize_with<T, 512>(q, s, out, n, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
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
// or bf16 (dtype 1); block 128, 256 or 512.
extern "C" int quant8_dequantize_launch(const void* q, const void* s,
                                        void* out, long long rows, int block,
                                        int dtype, void* stream) {
  if (rows <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* qp = static_cast<const int8_t*>(q);
  const float* sp = static_cast<const float*>(s);
  switch (dtype) {
    case 0:
      return dequantize_as<float>(qp, sp, out, rows * block, block, st);
    case 1:
      return dequantize_as<__nv_bfloat16>(qp, sp, out, rows * block, block,
                                          st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
