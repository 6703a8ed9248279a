// Shared pieces of the FA-2 kernels for Hopper (sm_90a):
// flash_attn_fwd.cu (forward) and flash_attn_bwd.cu (dq and dk/dv).
//
// Replaces the Pallas TPU kernels in
//   src/repro/kernels/flash_attention/kernel.py
// (_fa_fwd_kernel, _fa_bwd_dq_kernel, _fa_bwd_dkdv_kernel).  The math is
// theirs: fp32 scores s = q.k * scale, masked to -1e30 (causal, sliding
// window, ragged tail), online softmax forward with O(S) residuals
// (out, lse), and the recompute backward p = exp(s - lse),
// ds = p * (do.v - delta) * scale.  The tiling is the GPU's own:
//  * a block owns one 64-row tile and loops over the other operand's
//    64-row tiles; causal and window bounds are the loop's bounds (the TPU
//    kernels visited a dense grid and predicated dead blocks out with
//    _block_live), and a ragged last tile is masked in place (the TPU
//    kernels padded S and T to 128);
//  * 256 threads as 16 x 16; thread (tx, ty) holds the 4 x 4 micro-tile of
//    rows ty*4 + i and columns tx + 16*j of every 64 x 64 product, and
//    the same rows x columns tx + 16*j of its (rows x head_dim) sum;
//  * tiles are staged in shared memory as fp32 (bf16 is converted on
//    load), one operand transposed ([D][68]: the 4 rows of a thread are one
//    float4) and the other row-major with a padded stride ([64][D+1]: the 16
//    columns of a half-warp hit 16 banks), so the inner product runs on the
//    CUDA cores in fp32, as the Pallas bodies upcast every tile to fp32.
// What bounds it on an H100: the fp32 FMA rate and shared-memory loads
// (five loads for 16 FMAs in the inner loop), far from the bf16 tensor-core
// bound the work allows.  mma.sync / wgmma tiles are later work.
//
// Tensors are addressed through (batch, head, row) strides with a
// contiguous last dimension, so (B, S, H, D) activations are read and
// written in place through (B, H, S, D) views; lse and delta are
// contiguous (B, H, S) fp32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace fa {

constexpr int kBlock = 64;         // rows of every tile
constexpr int kThreads = 256;      // 16 x 16
constexpr int kLdT = kBlock + 4;   // stride of a transposed [D][kLdT] tile
constexpr float kNegInf = -1e30f;  // large-negative, never -inf

struct Strides {
  long long b, h, s;               // elements; the last dimension is dense
};

// One parameter block for all three kernels (each reads what it needs).
// Mirrored field for field by a ctypes.Structure in
// src/repro_torch/kernels/flash_attention/kernel.py.
struct Params {
  const void* q;       // (B, H, S, D)  T
  const void* k;       // (B, K, T, D)  T
  const void* v;       // (B, K, T, D)  T
  const void* dout;    // (B, H, S, D)  T   (backward)
  void* out;           // (B, H, S, D)  T   (forward)
  float* lse;          // (B, H, S)  written by the forward, read backward
  const float* delta;  // (B, H, S)  rowsum(do * out)     (backward)
  float* dq;           // (B, H, S, D) fp32                (backward)
  float* dk;           // (B, K, T, D) fp32, summed over the group
  float* dv;           // (B, K, T, D) fp32, summed over the group
  Strides sq, sk, sv, sdo, so, sdq, sdk, sdv;
  int B, H, K, S, T, group, causal, window;
  float scale;
};

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

__device__ __forceinline__ long long row_off(const Strides& st, int b, int h,
                                             int r) {
  return b * st.b + h * st.h + static_cast<long long>(r) * st.s;
}

// dst[d * kLdT + r] = row (row0 + r) of the (b, h) slice; zeros past `rows`.
template <typename T, int D>
__device__ __forceinline__ void load_tile_t(float* dst, const void* base,
                                            const Strides& st, int b, int h,
                                            int row0, int rows) {
  const T* src = static_cast<const T*>(base);
  for (int i = threadIdx.x; i < kBlock * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    dst[d * kLdT + r] = r < rows ? to_f(src[row_off(st, b, h, row0 + r) + d])
                                 : 0.f;
  }
}

// dst[r * (D + 1) + d] = row (row0 + r) of the (b, h) slice; zeros past rows.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const void* base,
                                          const Strides& st, int b, int h,
                                          int row0, int rows) {
  const T* src = static_cast<const T*>(base);
  for (int i = threadIdx.x; i < kBlock * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    dst[r * (D + 1) + d] =
        r < rows ? to_f(src[row_off(st, b, h, row0 + r) + d]) : 0.f;
  }
}

// acc[i][j] += sum_d at[d][ty*4 + i] * bs[tx + 16*j][d]
template <int D>
__device__ __forceinline__ void tile_dot(float (&acc)[4][4], const float* at,
                                         const float* bs, int tx, int ty) {
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    const float4 a = *reinterpret_cast<const float4*>(at + d * kLdT + ty * 4);
    const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float bv = bs[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(av[i], bv, acc[i][j]);
    }
  }
}

// Reductions over the 16 lanes tx = 0..15 that share a ty (half a warp).
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Does query row qp see key kp?  (JAX kernel.py _tile_mask, plus q_len.)
__device__ __forceinline__ bool visible(const Params& p, int qp, int kp) {
  bool ok = qp < p.S && kp < p.T;
  if (p.causal) ok = ok && kp <= qp;
  if (p.window > 0) ok = ok && kp > qp - p.window;
  return ok;
}

// Key tiles [*k_begin, *k_end) that query rows [q0, q1) may see.
__device__ __forceinline__ void kv_range(const Params& p, int q0, int q1,
                                         int* k_begin, int* k_end) {
  *k_end = p.causal ? min(p.T, q1) : p.T;
  const int lo = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  *k_begin = (lo / kBlock) * kBlock;
}

// Query tiles [*q_begin, *q_end) that may see keys [k0, k1).
__device__ __forceinline__ void q_range(const Params& p, int k0, int k1,
                                        int* q_begin, int* q_end) {
  const int lo = p.causal ? k0 : 0;
  *q_begin = (lo / kBlock) * kBlock;
  *q_end = p.window > 0 ? min(p.S, k1 - 1 + p.window) : p.S;
}

// Raise the dynamic shared memory limit when needed, launch, and return
// cudaGetLastError() (a refused launch never runs).
template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, const Params& p,
                   cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace fa
