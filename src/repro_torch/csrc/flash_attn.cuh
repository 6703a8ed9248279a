// Shared pieces of the FA-2 kernels for Hopper (sm_90a):
// flash_attn_fwd.cu (forward) and flash_attn_bwd.cu (dq and dk/dv).
//
// Replaces the Pallas TPU kernels in
//   src/repro/kernels/flash_attention/kernel.py
// (_fa_fwd_kernel, _fa_bwd_dq_kernel, _fa_bwd_dkdv_kernel).  The math is
// theirs: fp32 scores s = q.k * scale, masked to -1e30 (causal, sliding
// window, ragged tail), online softmax forward with O(S) residuals
// (out, lse), and the recompute backward p = exp(s - lse),
// ds = p * (do.v - delta) * scale.  The tiling is the GPU's own: a block
// owns one 64-row tile and loops over the other operand's tiles; causal
// and window bounds are the loop's bounds (the TPU kernels visited a
// dense grid and predicated dead blocks out with _block_live), and a
// ragged last tile is masked in place (the TPU kernels padded S and T to
// 128).  All three are bound by operations on this card (1e11 FLOP
// against ~70 MB of I/O at opt-1.3b's shape).
//
// Two designs live here:
//  * bf16 inputs (all three kernels): the products run on the tensor cores
//    (mma.sync m16n8k16, bf16 operands, fp32 accumulators).  4 warps, each
//    owning 16 rows of the block's tile; tiles arrive as bf16 by cp.async
//    (double-buffered, rows padded to width + 8 so ldmatrix meets no bank
//    conflict, rows past S / T zero-filled); the score accumulators are
//    the A fragments of the next product, so P and dS never leave the
//    registers.  P and dS are fp32 values: each is split into
//    hi = bf16(x) and lo = bf16(x - hi) and both halves are multiplied,
//    which keeps the products to the Pallas bodies' fp32 within 2^-18.
//  * fp32 inputs: the products run on the CUDA cores in fp32.  256
//    threads as 16 x 16; thread (tx, ty) holds the 4 x 4 micro-tile of
//    rows ty*4 + i and columns tx + 16*j of every 64-column product; tiles
//    are staged in shared memory as fp32, one operand transposed
//    ([width][68]) and the other row-major with a padded stride
//    ([64][width+1]).  Bound by the fp32 FMA rate and shared-memory loads
//    (five loads for 16 FMAs in the inner loop).  No bf16 product can
//    meet the fp32 bars, so fp32 stays here by design.
//
// Every kernel is templated on the head width D (q, k, dq, dk) and the
// value width Dv (v, do, out, dv): q.k^T sums over D, do.v^T over Dv.
// by_head_dims instantiates the pairs the configs use; the wrapper
// zero-pads any other D <= 192, Dv <= 128 to the next pair.
//
// Tensors are addressed through (batch, head, row) strides with a
// contiguous last dimension, so (B, S, H, D) activations are read and
// written in place through (B, H, S, D) views; lse and delta are
// contiguous (B, H, S) fp32.  The bf16 kernels need every row start 16-byte
// aligned (the wrapper checks it).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdio>
#include <type_traits>

namespace fa {

constexpr int kBlock = 64;         // rows of every tile
constexpr int kThreads = 256;      // 16 x 16
constexpr int kLdT = kBlock + 4;   // stride of a transposed [D][kLdT] tile
constexpr float kNegInf = -1e30f;  // large-negative, never -inf
constexpr int kTcThreads = 128;    // tensor-core kernels: 4 warps x 16 rows
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNegInf2 = kNegInf * kLog2e;  // the mask in log2 units

using bf16 = __nv_bfloat16;

struct Strides {
  long long b, h, s;               // elements; the last dimension is dense
};

// One parameter block for all three kernels (each reads what it needs).
// Mirrored field for field by a ctypes.Structure in
// src/repro_torch/kernels/flash_attention/kernel.py.
struct Params {
  const void* q;       // (B, H, S, D)  T
  const void* k;       // (B, K, T, D)  T
  const void* v;       // (B, K, T, Dv)  T
  const void* dout;    // (B, H, S, Dv)  T   (backward)
  void* out;           // (B, H, S, Dv)  T   (forward)
  float* lse;          // (B, H, S)  written by the forward, read backward
  const float* delta;  // (B, H, S)  rowsum(do * out)     (backward)
  float* dq;           // (B, H, S, D) fp32                (backward)
  float* dk;           // (B, K, T, D) fp32, summed over the group
  float* dv;           // (B, K, T, Dv) fp32, summed over the group
  Strides sq, sk, sv, sdo, so, sdq, sdk, sdv;
  int B, H, K, S, T, D, Dv, group, causal, window;
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

// Every (query, key) pair of rows [q0, q0 + nq) x keys [k0, k0 + nk)
// visible?  Then a tile needs no mask.
__device__ __forceinline__ bool all_visible(const Params& p, int q0, int nq,
                                            int k0, int nk) {
  bool ok = q0 + nq <= p.S && k0 + nk <= p.T;
  if (p.causal) ok = ok && k0 + nk - 1 <= q0;
  if (p.window > 0) ok = ok && k0 > q0 + nq - 1 - p.window;
  return ok;
}

// ---- tensor-core pieces (bf16 kernels) ----------------------------------

__device__ __forceinline__ unsigned smem_u32(const void* ptr) {
  return static_cast<unsigned>(__cvta_generic_to_shared(ptr));
}

// Asynchronous copies global -> shared; a source size of 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// dst[r * (D + 8) + d] = row (row0 + r) of the (b, h) slice as bf16, for
// r < kRows; zeros past `rows`.  16 bytes a copy, the block's threads
// taking every kTcThreads-th chunk; the slice's base is computed once.
template <int D, int kRows>
__device__ __forceinline__ void cp_tile(bf16* dst, const void* base,
                                        const Strides& st, int b, int h,
                                        int row0, int rows) {
  constexpr int kChunks = D / 8, kN = kRows * kChunks;
  const bf16* src = static_cast<const bf16*>(base);
  const bf16* first = src + row_off(st, b, h, row0);
#pragma unroll
  for (int it = 0; it < (kN + kTcThreads - 1) / kTcThreads; ++it) {
    const int i = it * kTcThreads + threadIdx.x;
    if (kN % kTcThreads != 0 && i >= kN) break;
    const int r = i / kChunks, c = (i - r * kChunks) * 8;
    const bool in = r < rows;
    cp_async16(dst + r * (D + 8) + c, in ? first + r * st.s + c : src,
               in ? 16 : 0);
  }
}

// Four 8 x 8 bf16 matrices from shared memory; lanes 8i .. 8i+7 give the
// row addresses of matrix i, which lands in r[i].  _t transposes each.
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(ptr)));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const bf16* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(ptr)));
}

// c += a . b on the tensor cores: a 16 x 16 (row), b 16 x 8 (col), fp32 c.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x0, x1) -> bf16 pairs hi = bf16(x), lo = bf16(x - hi); hi + lo is x to
// within 2^-18 |x| (x - hi is exact in fp32).
__device__ __forceinline__ void split2(float x0, float x1, unsigned& hi,
                                       unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = *reinterpret_cast<const unsigned*>(&l);
}

// 2^x by the special-function unit alone (relative error ~2^-22; results
// below 2^-126 flush to 0, as the masked -1e30 scores do anyway).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Fragment layout of a warp's m16n8 fp32 accumulator c[4] (g = lane / 4,
// t = lane % 4): c[0], c[1] are row g, columns 2t, 2t+1; c[2], c[3] row
// g + 8.  Two neighbouring n-tiles of it are exactly the m16k16 A
// fragment of the next product, which is how P and dS stay in registers.

// acc[j] += A . B[8j .. 8j+8)^T for j < N / 8, on one warp: A is 16 rows
// of a bf16 tile and B a bf16 tile of N rows, both in shared memory with
// row stride D + 8 and the head dimension D contiguous.
template <int D, int N>
__device__ __forceinline__ void mma_abt(float (&acc)[N / 8][4], const bf16* a,
                                        const bf16* b, int lane) {
  constexpr int LD = D + 8;
  const int r = lane & 7, r8 = ((lane >> 3) & 1) * 8, c8 = (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    unsigned af[4];
    ldsm_x4(af, a + (r + r8) * LD + kk * 16 + c8);
#pragma unroll
    for (int j = 0; j < N / 8; j += 2) {
      unsigned bf[4];
      ldsm_x4(bf, b + (j * 8 + r + c8) * LD + kk * 16 + r8);
      mma_bf16(acc[j], af, bf[0], bf[1]);
      mma_bf16(acc[j + 1], af, bf[2], bf[3]);
    }
  }
}

// acc[n] += X . B[:, 8n .. 8n+8) for n < D / 8, on one warp: X is the
// warp's 16 x N fp32 accumulator tile x[N / 8][4] (P or dS), multiplied as
// its hi and lo bf16 halves; B is an N x D bf16 tile in shared memory
// (row stride D + 8), read across rows with ldmatrix.trans.  Each B
// fragment feeds four products.
template <int D, int N>
__device__ __forceinline__ void mma_split_xb(float (&acc)[D / 8][4],
                                             const float (&x)[N / 8][4],
                                             const bf16* b, int lane) {
  constexpr int LD = D + 8;
  const int r = lane & 7, r8 = ((lane >> 3) & 1) * 8, c8 = (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    unsigned hi[4], lo[4];
    split2(x[2 * kk][0], x[2 * kk][1], hi[0], lo[0]);
    split2(x[2 * kk][2], x[2 * kk][3], hi[1], lo[1]);
    split2(x[2 * kk + 1][0], x[2 * kk + 1][1], hi[2], lo[2]);
    split2(x[2 * kk + 1][2], x[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
    for (int n = 0; n < D / 8; n += 2) {
      unsigned bf[4];
      ldsm_x4_t(bf, b + (kk * 16 + r + r8) * LD + n * 8 + c8);
      mma_bf16(acc[n], hi, bf[0], bf[1]);
      mma_bf16(acc[n + 1], hi, bf[2], bf[3]);
      mma_bf16(acc[n], lo, bf[0], bf[1]);
      mma_bf16(acc[n + 1], lo, bf[2], bf[3]);
    }
  }
}

// Calls f(std::integral_constant<int, D>{}, std::integral_constant<int,
// Dv>{}) for the (D, Dv) pairs the configs use: D = Dv in 32, 64, 96,
// 128 (the dense models), (96, 64) and (192, 128) (MLA's qk and v widths,
// smoke and full); anything else is refused.
template <typename F>
cudaError_t by_head_dims(int d, int dv, F f) {
  using std::integral_constant;
  if (d == dv) {
    switch (d) {
      case 32: return f(integral_constant<int, 32>{},
                        integral_constant<int, 32>{});
      case 64: return f(integral_constant<int, 64>{},
                        integral_constant<int, 64>{});
      case 96: return f(integral_constant<int, 96>{},
                        integral_constant<int, 96>{});
      case 128: return f(integral_constant<int, 128>{},
                         integral_constant<int, 128>{});
      default: return cudaErrorInvalidValue;
    }
  }
  if (d == 96 && dv == 64)
    return f(integral_constant<int, 96>{}, integral_constant<int, 64>{});
  if (d == 192 && dv == 128)
    return f(integral_constant<int, 192>{}, integral_constant<int, 128>{});
  return cudaErrorInvalidValue;
}

// The instantiation a library's launcher last launched, named as the
// profiler names it (each library is one translation unit with its own
// copy); its wrapper reads it back after every launch.
static char last_kernel[96];

template <typename... Args>
void note_kernel(const char* fmt, Args... args) {
  std::snprintf(last_kernel, sizeof last_kernel, fmt, args...);
}

// Raise the dynamic shared memory limit when needed, launch, and return
// cudaGetLastError() (a refused launch never runs).
template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, const Params& p,
                   cudaStream_t stream, int threads = kThreads) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace fa
