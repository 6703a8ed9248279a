// Paged split-KV flash-decoding for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/decode.py::_flash_decode_kernel
// (launched by _decode_bkgd / flash_decode_paged).  Same function: for
// every (sequence b, KV head h, page split s) an online softmax over the
// pages of b's block table, for the C*g query rows of that head (GQA group
// g, C teacher-forced chunk rows, chunk-major: row r is chunk index r / g
// and sees seq_len + r / g positions, optionally only the last `window`).
// Each block writes fp32 partials (m, l, acc); the wrapper merges the
// splits with the logsumexp rescale (decode.py:308-317).
//
// What bounds it on an H100: page bytes.  The work per page is about
// 2*(D+Dv)*C*g FLOP against bs*K*(D+Dv)*bytes read, a handful of FLOP per
// byte, far under the card's ~295 FLOP/byte ridge.  At B=8 sequences of
// 2048 tokens, K=4, D=128 in bf16 the kernel must read ~33.5 MB of pages,
// ~10 us at 3.35 TB/s.
//
// This first design is simple and correct, not fast:
//  * grid (B, K, num_splits), 256 threads; each block reads its own block
//    table row and walks only the live pages of its split: the loop bounds
//    come from seq_len, C and window, so dead pages (past the last row's
//    length, or left of the first row's window) are never read and the
//    table is never read past the live range (the TPU kernel predicated a
//    dense grid and clamped overhanging table reads instead);
//  * every page is staged once in shared memory as fp32 (bf16 converted,
//    int8 dequantized with its per-(slot, head) scales right after the
//    load), so each page byte crosses HBM exactly once per (b, h); the
//    products run on the CUDA cores in fp32, not on the tensor cores;
//  * masked scores are -1e30, never -inf, and a fully masked row adds
//    nothing, so a split with no live page emits (m=-1e30, l=0, acc=0) and
//    vanishes in the merge, and a slot with seq_len == 0 yields 0, not NaN.
// Left for later: cp.async/TMA double buffering of the page loads, 16-byte
// vector loads, and wgmma for the C*g x bs score tile of chunked prefill.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;

template <typename T> __device__ __forceinline__ float to_float(T x);
template <> __device__ __forceinline__ float to_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_float<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_float<int8_t>(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_decode_split_kernel(
    const float* __restrict__ q,           // (B, K, CG, D) fp32
    const T* __restrict__ k_pages,         // (P, bs, K, D)
    const T* __restrict__ v_pages,         // (P, bs, K, Dv)
    const float* __restrict__ k_scale,     // (P, bs, K) or null
    const float* __restrict__ v_scale,     // (P, bs, K) or null
    const int* __restrict__ block_tables,  // (B, nb)
    const int* __restrict__ seq_lens,      // (B,)
    float* __restrict__ m_out,             // (B, K, S, CG)
    float* __restrict__ l_out,             // (B, K, S, CG)
    float* __restrict__ acc_out,           // (B, K, S, CG, Dv)
    int K, int CG, int D, int Dv, int bs, int nb, int pps, int group,
    int chunk, int window, float scale) {
  const int b = blockIdx.x, h = blockIdx.y, si = blockIdx.z;
  const int num_splits = gridDim.z;
  const int tid = threadIdx.x;

  extern __shared__ float smem[];
  const int ldk = D + 1;                   // padded: conflict-free q.k loop
  float* qs = smem;                        // CG * D
  float* acc = qs + CG * D;                // CG * Dv
  float* ks = acc + CG * Dv;               // bs * ldk
  float* vs = ks + bs * ldk;               // bs * Dv
  float* sc = vs + bs * Dv;                // CG * bs scores, then probs
  float* m_s = sc + CG * bs;               // CG running max
  float* l_s = m_s + CG;                   // CG running sum
  float* a_s = l_s + CG;                   // CG rescale of this page

  const int seq_len = seq_lens[b];
  // live pages [lo, hi): some row may attend to them (decode.py _page_live)
  int hi = (seq_len + chunk - 1 + bs - 1) / bs;
  hi = hi < nb ? hi : nb;
  int lo = 0;
  if (window > 0 && seq_len - window > 0) lo = (seq_len - window) / bs;
  const int p0 = max(lo, si * pps);
  const int p1 = min(hi, (si + 1) * pps);

  const float* qb = q + (static_cast<size_t>(b) * K + h) * CG * D;
  for (int i = tid; i < CG * D; i += kThreads) qs[i] = qb[i];
  for (int i = tid; i < CG * Dv; i += kThreads) acc[i] = 0.f;
  for (int r = tid; r < CG; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  __syncthreads();

  const int* bt = block_tables + static_cast<size_t>(b) * nb;
  for (int page = p0; page < p1; ++page) {
    const size_t slot0 = static_cast<size_t>(bt[page]) * bs;
    for (int i = tid; i < bs * D; i += kThreads) {
      const int t = i / D, d = i - t * D;
      const size_t row = (slot0 + t) * K + h;
      float x = to_float(k_pages[row * D + d]);
      if (k_scale != nullptr) x *= k_scale[row];
      ks[t * ldk + d] = x;
    }
    for (int i = tid; i < bs * Dv; i += kThreads) {
      const int t = i / Dv, d = i - t * Dv;
      const size_t row = (slot0 + t) * K + h;
      float x = to_float(v_pages[row * Dv + d]);
      if (v_scale != nullptr) x *= v_scale[row];
      vs[t * Dv + d] = x;
    }
    __syncthreads();

    for (int i = tid; i < CG * bs; i += kThreads) {
      const int r = i / bs, t = i - r * bs;
      const float* qr = qs + r * D;
      const float* kt = ks + t * ldk;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], kt[d], s);
      const int pos = page * bs + t;
      const int valid = seq_len + r / group;
      bool ok = pos < valid;
      if (window > 0) ok = ok && (pos > valid - 1 - window);
      sc[i] = ok ? s * scale : kNegInf;
    }
    __syncthreads();

    for (int r = tid; r < CG; r += kThreads) {
      float* sr = sc + r * bs;
      const float m_prev = m_s[r];
      float m_new = m_prev;
      for (int t = 0; t < bs; ++t) m_new = fmaxf(m_new, sr[t]);
      float sum = 0.f;
      for (int t = 0; t < bs; ++t) {
        const float p = sr[t] > 0.5f * kNegInf ? expf(sr[t] - m_new) : 0.f;
        sr[t] = p;
        sum += p;
      }
      const float alpha = expf(m_prev - m_new);
      l_s[r] = l_s[r] * alpha + sum;
      m_s[r] = m_new;
      a_s[r] = alpha;
    }
    __syncthreads();

    for (int i = tid; i < CG * Dv; i += kThreads) {
      const int r = i / Dv, d = i - r * Dv;
      const float* pr = sc + r * bs;
      float a = acc[i] * a_s[r];
      for (int t = 0; t < bs; ++t) a = fmaf(pr[t], vs[t * Dv + d], a);
      acc[i] = a;
    }
    __syncthreads();
  }

  const size_t ob = ((static_cast<size_t>(b) * K + h) * num_splits + si) * CG;
  for (int r = tid; r < CG; r += kThreads) {
    m_out[ob + r] = m_s[r];
    l_out[ob + r] = l_s[r];
  }
  for (int i = tid; i < CG * Dv; i += kThreads) acc_out[ob * Dv + i] = acc[i];
}

template <typename T>
cudaError_t launch(const float* q, const void* k_pages, const void* v_pages,
                   const float* k_scale, const float* v_scale,
                   const int* block_tables, const int* seq_lens, float* m_out,
                   float* l_out, float* acc_out, int B, int K, int CG, int D,
                   int Dv, int bs, int nb, int pps, int num_splits, int group,
                   int chunk, int window, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(CG) * D + static_cast<size_t>(CG) * Dv +
       static_cast<size_t>(bs) * (D + 1) + static_cast<size_t>(bs) * Dv +
       static_cast<size_t>(CG) * bs + 3 * static_cast<size_t>(CG));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_decode_split_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(B, K, num_splits);
  flash_decode_split_kernel<T><<<grid, kThreads, smem, stream>>>(
      q, static_cast<const T*>(k_pages), static_cast<const T*>(v_pages),
      k_scale, v_scale, block_tables, seq_lens, m_out, l_out, acc_out, K, CG,
      D, Dv, bs, nb, pps, group, chunk, window, scale);
  return cudaGetLastError();
}

}  // namespace

// page_dtype: 0 float32, 1 bfloat16, 2 int8 (then k_scale/v_scale are set).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int flash_decode_paged_launch(
    const float* q, const void* k_pages, const void* v_pages,
    const float* k_scale, const float* v_scale, const int* block_tables,
    const int* seq_lens, float* m_out, float* l_out, float* acc_out, int B,
    int K, int CG, int D, int Dv, int bs, int nb, int pps, int num_splits,
    int group, int chunk, int window, float scale, int page_dtype,
    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (page_dtype) {
    case 0:
      return launch<float>(q, k_pages, v_pages, k_scale, v_scale,
                           block_tables, seq_lens, m_out, l_out, acc_out, B, K,
                           CG, D, Dv, bs, nb, pps, num_splits, group, chunk,
                           window, scale, s);
    case 1:
      return launch<__nv_bfloat16>(q, k_pages, v_pages, k_scale, v_scale,
                                   block_tables, seq_lens, m_out, l_out,
                                   acc_out, B, K, CG, D, Dv, bs, nb, pps,
                                   num_splits, group, chunk, window, scale, s);
    case 2:
      return launch<int8_t>(q, k_pages, v_pages, k_scale, v_scale,
                            block_tables, seq_lens, m_out, l_out, acc_out, B,
                            K, CG, D, Dv, bs, nb, pps, num_splits, group,
                            chunk, window, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
