// FA-2 forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py::_fa_fwd_kernel
// (launched by _fwd_bhsd).  Same function: for each (b, h, 64-row query
// tile) an online softmax over the key tiles of kv head h / group, with
// the running max m, the running sum l and the output accumulator in fp32;
// it writes out = acc / l in the input dtype and lse = m + log(l) in fp32.
// Tiling, masks and what bounds it: see flash_attn.cuh.
//
// At opt-1.3b's shape (B=4, S=2048, H=32, D=64, causal, bf16) the work is
// 6.9e10 FLOP over ~68 MB of I/O: bound by operations on this card.

#include "flash_attn.cuh"

namespace {

using namespace fa;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) fa_fwd_kernel(const Params p) {
  constexpr int DJ = D / 16;  // output columns tx + 16*jj per thread
  const int q0 = blockIdx.x * kBlock, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / p.group;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                      // [D][kLdT]      q^T
  float* ks = qt + D * kLdT;             // [kBlock][D+1]  k
  float* vs = ks + kBlock * (D + 1);     // [kBlock][D+1]  v
  float* pt = vs + kBlock * (D + 1);     // [kBlock][kLdT] p^T

  const int q1 = min(p.S, q0 + kBlock);
  load_tile_t<T, D>(qt, p.q, p.sq, b, h, q0, q1 - q0);
  int k_begin, k_end;
  kv_range(p, q0, q1, &k_begin, &k_end);

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) acc[i][jj] = 0.f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += kBlock) {
    __syncthreads();  // q loaded; the previous tile's readers are done
    const int rows = min(kBlock, p.T - k0);
    load_tile<T, D>(ks, p.k, p.sk, b, hk, k0, rows);
    load_tile<T, D>(vs, p.v, p.sv, b, hk, k0, rows);
    __syncthreads();

    float s[4][4] = {};
    tile_dot<D>(s, qt, ks, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = visible(p, qp, k0 + tx + 16 * j) ? s[i][j] * p.scale
                                                   : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      l[i] = alpha * l[i] + half_warp_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) acc[i][jj] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) pt[(tx + 16 * j) * kLdT + ty * 4 + i] = s[i][j];
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBlock; ++c) {
      const float4 pv = *reinterpret_cast<const float4*>(pt + c * kLdT + ty * 4);
      const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) {
        const float vv = vs[c * (D + 1) + tx + 16 * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][jj] = fmaf(pr[i], vv, acc[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    if (qp >= p.S) continue;
    const float L = fmaxf(l[i], 1e-30f);
    T* orow = static_cast<T*>(p.out) + row_off(p.so, b, h, qp);
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) orow[tx + 16 * jj] = from_f<T>(acc[i][jj] / L);
    if (tx == 0)
      p.lse[(static_cast<long long>(b) * p.H + h) * p.S + qp] = m[i] + logf(L);
  }
}

template <typename T, int D>
cudaError_t run(const Params& p, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (D * kLdT + 2 * kBlock * (D + 1) + kBlock * kLdT);
  const dim3 grid((p.S + kBlock - 1) / kBlock, p.H, p.B);
  return launch(fa_fwd_kernel<T, D>, grid, smem, p, stream);
}

template <typename T>
cudaError_t run_head_dim(const Params& p, int head_dim, cudaStream_t stream) {
  switch (head_dim) {
    case 32: return run<T, 32>(p, stream);
    case 64: return run<T, 64>(p, stream);
    case 96: return run<T, 96>(p, stream);
    case 128: return run<T, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16; head_dim 32, 64, 96 or 128.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int fa_fwd_launch(const fa::Params* p, int dtype, int head_dim,
                             void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(run_head_dim<float>(*p, head_dim, s));
    case 1:
      return static_cast<int>(run_head_dim<__nv_bfloat16>(*p, head_dim, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
