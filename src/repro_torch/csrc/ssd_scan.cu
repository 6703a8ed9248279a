// Mamba2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/ssd_scan/kernel.py::_ssd_kernel   (ssd_bhcq)
// Same function.  For one (batch b, head h), with head h reading B/C group
// h / (heads / groups), the chunks of Q positions run in order and carry a
// (p x n) fp32 state S, zero at the start.  Per chunk, all in fp32:
//   xd = x * dt                     (Q, p)
//   cs = inclusive cumsum of dt * A (Q,)
//   y  = ((C B^T) o L) xd + (C o exp(cs)) S^T,   L[i,j] = exp(cs_i - cs_j)
//                                                 for i >= j, 0 otherwise
//   S  = exp(cs_last) S + xd^T (B o exp(cs_last - cs))
// and y is written in x's dtype.  L is formed from the difference
// cs_i - cs_j (<= 0), never as exp(cs_i) * exp(-cs_j): cs is a sum of up
// to Q negative terms and exp(-cs_j) would overflow fp32.  The TPU kernel
// needed S to be a multiple of the chunk (its caller padded); here
// positions >= S read as dt = x = B = C = 0, which leaves the state
// unchanged, and their rows of y are not written, so the caller makes no
// padded copy.  Every tensor is read through its strides (the last
// dimension dense), so the model's (b, s, h, p) activations go in as
// transposed views.
//
// What bounds it on an H100: at mamba2-130m's prefill (b 8, s 4096, h 24,
// p 64, n 128, Q 128, bf16) the scan moves 221 MB (0.066 ms at 3.35 TB/s)
// and does 6.44e10 FLOP (0.065 ms at the 989 TFLOP/s of bf16 tensor
// cores, 0.96 ms at the 67 TFLOP/s of fp32 CUDA cores).  This first
// version does its products on the CUDA cores in fp32, as the reference
// does, so it is bound by operations; tensor-core tiles are a later step.
//
// Design (simple first): one block of 256 threads per (b, h), looping over
// the chunks in order with S resident in shared memory.  Per chunk it
// stages B (Q x n) and xd (Q x p) as fp32, takes the cumsum in one warp
// (in fp64, rounded once to fp32, so that it does not depend on the order),
// then walks the chunk in tiles of RT rows: it stages that tile of C, forms
// the tile of (C B^T) o L (only the columns j below the tile's last row),
// and from it and S the tile of y; last it updates S in place.  Products
// are register tiles over a 16 x 16 thread grid whose rows and columns are
// strided by 16, which keeps every shared-memory read a broadcast or a
// conflict-free row (operands stored row-major with an odd row pitch).
// Global loads are 16-byte vectors.  At mamba2-130m's shape this needs
// 195 KB of shared memory (the opt-in limit is 227 KB); RT shrinks from 64
// for larger (p, n).  192 blocks fill 132 SMs in 1.45 waves.
// Left for later: tensor-core (mma / wgmma) tiles, overlapping the next
// chunk's loads with this chunk's products, and splitting the chunk
// recurrence so that more blocks are in flight.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ssd {

// Mirror of _Params in kernels/ssd_scan/kernel.py.  Outside the anonymous
// namespace: the extern "C" launcher takes it, and a type with internal
// linkage would give that launcher internal linkage too.
struct Params {
  const void* x;    // (b, h, s, p), x's dtype
  const float* dt;  // (b, h, s) fp32
  const float* A;   // (h,) fp32
  const void* B;    // (b, g, s, n), x's dtype
  const void* C;    // (b, g, s, n), x's dtype
  void* y;          // (b, h, s, p), x's dtype
  long long seqlen;
  long long xb, xh, xs;  // element strides; the last dimension is dense
  long long db, dh, ds;
  long long bb, bg, bs;
  long long cb, cg, cs;
  long long yb, yh, ys;
  int batch, heads, groups, p, n, chunk;
};

}  // namespace ssd

namespace {

using ssd::Params;

constexpr int kThreads = 256;
constexpr int kGrid = 16;         // 16 x 16 threads over each output tile
constexpr int kMaxDim = 128;      // p, n and the chunk are at most this
constexpr int kMaxSmem = 232448;  // opt-in shared memory of a block

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// rows x width elements of src (row stride `stride`, rows at or past
// `valid` read as 0) -> fp32 dst with row pitch `ld`, each value times
// scale[row] when scale is given.  16-byte loads; width is a multiple of
// the vector (checked by the wrapper).
template <typename T>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src,
                                      long long stride, int rows, int width,
                                      int valid, const float* scale) {
  constexpr int kVec = 16 / sizeof(T);
  const int per_row = width / kVec;
#pragma unroll 4
  for (int idx = threadIdx.x; idx < rows * per_row; idx += kThreads) {
    const int r = idx / per_row;
    const int c = (idx - r * per_row) * kVec;
    alignas(16) T raw[kVec];
    if (r < valid) {
      *reinterpret_cast<uint4*>(raw) =
          *reinterpret_cast<const uint4*>(src + r * stride + c);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) raw[e] = from_float<T>(0.0f);
    }
    const float s = scale ? scale[r] : 1.0f;
#pragma unroll
    for (int e = 0; e < kVec; ++e) dst[r * ld + c + e] = to_float(raw[e]) * s;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_scan_kernel(const Params P, const int RT) {
  extern __shared__ float smem[];
  const int Q = P.chunk, p = P.p, n = P.n;
  const int ldb = n + 1, ldg = Q + 1;
  float* Bs = smem;            // (Q, n)  B of the chunk
  float* Cs = Bs + Q * ldb;    // (RT, n) C of the row tile
  float* Xs = Cs + RT * ldb;   // (Q, p)  x * dt
  float* Gs = Xs + Q * p;      // (RT, Q) (C B^T) o L of the row tile
  float* Ss = Gs + RT * ldg;   // (p, n)  the state
  float* cs = Ss + p * ldb;    // (Q,)    cumsum of dt * A
  float* ecs = cs + Q;         // exp(cs)
  float* dec = ecs + Q;        // exp(cs_last - cs)
  float* dts = dec + Q;        // dt

  const int tid = threadIdx.x;
  const int tx = tid % kGrid, ty = tid / kGrid;
  const int b = blockIdx.x / P.heads, h = blockIdx.x % P.heads;
  const int grp = h / (P.heads / P.groups);
  const float A = P.A[h];
  const T* x = static_cast<const T*>(P.x) + b * P.xb + h * P.xh;
  const float* dt = P.dt + b * P.db + h * P.dh;
  const T* Bg = static_cast<const T*>(P.B) + b * P.bb + grp * P.bg;
  const T* Cg = static_cast<const T*>(P.C) + b * P.cb + grp * P.cg;
  T* y = static_cast<T*>(P.y) + b * P.yb + h * P.yh;

  for (int i = tid; i < p * ldb; i += kThreads) Ss[i] = 0.0f;

  for (long long c0 = 0; c0 < P.seqlen; c0 += Q) {
    const int valid = static_cast<int>(
        P.seqlen - c0 < Q ? P.seqlen - c0 : static_cast<long long>(Q));
    for (int j = tid; j < Q; j += kThreads)
      dts[j] = j < valid ? dt[(c0 + j) * P.ds] : 0.0f;
    __syncthreads();
    stage<T>(Xs, p, x + c0 * P.xs, P.xs, Q, p, valid, dts);
    stage<T>(Bs, ldb, Bg + c0 * P.bs, P.bs, Q, n, valid, nullptr);
    if (tid < 32) {  // inclusive cumsum of dt * A over the chunk, one warp
      // summed in fp64 and rounded once: cs_j is the correctly rounded
      // prefix sum whatever the order, so the plain version (which does
      // the same) gets the same cs bit for bit and the two differ only in
      // the order of the products' sums
      constexpr int kPer = kMaxDim / 32;
      const int per = (Q + 31) / 32;
      double loc[kPer];
      double run = 0.0;
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        const int j = tid * per + e;
        if (e < per && j < Q) run += static_cast<double>(dts[j] * A);
        loc[e] = run;
      }
      double incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const double o = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += o;
      }
      double excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) excl = 0.0;
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        const int j = tid * per + e;
        if (e < per && j < Q) cs[j] = static_cast<float>(excl + loc[e]);
      }
    }
    __syncthreads();
    const float total = cs[Q - 1];
    for (int j = tid; j < Q; j += kThreads) {
      ecs[j] = expf(cs[j]);
      dec[j] = expf(total - cs[j]);
    }

    for (int i0 = 0; i0 < valid; i0 += RT) {
      const int rows = min(RT, valid - i0);
      const int jmax = i0 + rows;  // row i sees columns j <= i
      stage<T>(Cs, ldb, Cg + (c0 + i0) * P.cs, P.cs, rows, n, rows, nullptr);
      __syncthreads();

      // G[i][j] = sum_k C[i][k] B[j][k] * exp(cs_i - cs_j), j <= i
      {
        float acc[4][8] = {};
        for (int k = 0; k < n; ++k) {
          float a[4], v[8];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            a[r] = Cs[min(ty + r * kGrid, rows - 1) * ldb + k];
#pragma unroll
          for (int c = 0; c < 8; ++c)
            v[c] = Bs[min(tx + c * kGrid, jmax - 1) * ldb + k];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(a[r], v[c], acc[r][c]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = ty + r * kGrid;
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            const int j = tx + c * kGrid;
            if (i < rows && j < jmax)
              Gs[i * ldg + j] =
                  j <= i0 + i ? acc[r][c] * expf(cs[i0 + i] - cs[j]) : 0.0f;
          }
        }
      }
      __syncthreads();

      // y[i][:] = G[i][:] xd + exp(cs_i) * C[i][:] S^T
      {
        float acc[4][8] = {}, st[4][8] = {};
        for (int j = 0; j < jmax; ++j) {
          float a[4], v[8];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            a[r] = Gs[min(ty + r * kGrid, rows - 1) * ldg + j];
#pragma unroll
          for (int c = 0; c < 8; ++c)
            v[c] = Xs[j * p + min(tx + c * kGrid, p - 1)];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(a[r], v[c], acc[r][c]);
        }
        for (int k = 0; k < n; ++k) {
          float a[4], v[8];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            a[r] = Cs[min(ty + r * kGrid, rows - 1) * ldb + k];
#pragma unroll
          for (int c = 0; c < 8; ++c)
            v[c] = Ss[min(tx + c * kGrid, p - 1) * ldb + k];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 8; ++c) st[r][c] = fmaf(a[r], v[c], st[r][c]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = ty + r * kGrid;
          if (i >= rows) continue;
          const float e = ecs[i0 + i];
          T* row = y + (c0 + i0 + i) * P.ys;
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            const int j = tx + c * kGrid;
            if (j < p) row[j] = from_float<T>(acc[r][c] + e * st[r][c]);
          }
        }
      }
      __syncthreads();
    }

    // S[q][k] = exp(total) S[q][k] + sum_j xd[j][q] dec[j] B[j][k]
    {
      const float etot = expf(total);
      float acc[8][8] = {};
      for (int j = 0; j < valid; ++j) {
        const float d = dec[j];
        float a[8], v[8];
#pragma unroll
        for (int r = 0; r < 8; ++r)
          a[r] = Xs[j * p + min(ty + r * kGrid, p - 1)] * d;
#pragma unroll
        for (int c = 0; c < 8; ++c)
          v[c] = Bs[j * ldb + min(tx + c * kGrid, n - 1)];
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(a[r], v[c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int q = ty + r * kGrid;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int k = tx + c * kGrid;
          if (q < p && k < n)
            Ss[q * ldb + k] = fmaf(Ss[q * ldb + k], etot, acc[r][c]);
        }
      }
    }
    __syncthreads();
  }
}

size_t smem_bytes(int Q, int p, int n, int RT) {
  const size_t floats = static_cast<size_t>(Q) * (n + 1) +
                        static_cast<size_t>(RT) * (n + 1) +
                        static_cast<size_t>(Q) * p +
                        static_cast<size_t>(RT) * (Q + 1) +
                        static_cast<size_t>(p) * (n + 1) + 4 * Q;
  return floats * sizeof(float);
}

template <typename T>
int launch_as(const Params& P, cudaStream_t stream) {
  int RT = P.chunk < 64 ? P.chunk : 64;
  while (RT > 16 && smem_bytes(P.chunk, P.p, P.n, RT) > kMaxSmem) RT /= 2;
  const size_t bytes = smem_bytes(P.chunk, P.p, P.n, RT);
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_scan_kernel<T><<<P.batch * P.heads, kThreads, bytes, stream>>>(P, RT);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype 0: x, B, C and y fp32; 1: bf16.  dt and A are fp32.  p and n are
// multiples of 8 and at most 128, the chunk at most 128, groups divide
// heads; every pointer and row stride is 16-byte aligned (the wrapper
// checks all of it).
extern "C" int ssd_scan_launch(const ssd::Params* P, int dtype,
                               void* stream) {
  if (P->batch <= 0 || P->heads <= 0 || P->seqlen <= 0) return 0;
  if (P->p > kMaxDim || P->n > kMaxDim || P->chunk > kMaxDim ||
      P->chunk <= 0 || P->p % 8 || P->n % 8 || P->groups <= 0 ||
      P->heads % P->groups)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_as<float>(*P, st);
    case 1:
      return launch_as<__nv_bfloat16>(*P, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
