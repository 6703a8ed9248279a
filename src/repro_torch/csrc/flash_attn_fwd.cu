// FA-2 forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py::_fa_fwd_kernel
// (launched by _fwd_bhsd).  Same function: for each (b, h, 64-row query
// tile) an online softmax over the key tiles of kv head h / group, with
// the running max m, the running sum l and the output accumulator in fp32;
// it writes out = acc / l (Dv columns) in the input dtype and
// lse = m + log(l) in fp32.
//
// At opt-1.3b's shape (B=4, S=2048, H=32, D=64, causal, bf16) the work is
// 6.9e10 FLOP over ~68 MB of I/O: bound by operations on this card, so
// bf16 inputs run on the tensor cores (fa_fwd_tc_kernel): S = Q K^T by
// mma.sync from ldmatrix fragments, the softmax on the accumulators in
// registers, and P V with P as its hi and lo bf16 halves (3 products
// where an unsplit P takes 2; see flash_attn.cuh).  K and V tiles stream
// through two cp.async stages, the next tile's copy behind this tile's
// products.  fp32 inputs run on the CUDA cores (fa_fwd_kernel).

#include "flash_attn.cuh"

namespace {

using namespace fa;

template <typename T, int D, int Dv>
__global__ void __launch_bounds__(kThreads) fa_fwd_kernel(const Params p) {
  constexpr int DJ = Dv / 16;  // output columns tx + 16*jj per thread
  const int q0 = blockIdx.x * kBlock, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / p.group;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                      // [D][kLdT]      q^T
  float* ks = qt + D * kLdT;             // [kBlock][D+1]  k
  float* vs = ks + kBlock * (D + 1);     // [kBlock][Dv+1] v
  float* pt = vs + kBlock * (Dv + 1);    // [kBlock][kLdT] p^T

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
    load_tile<T, Dv>(vs, p.v, p.sv, b, hk, k0, rows);
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
        const float vv = vs[c * (Dv + 1) + tx + 16 * jj];
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

// bf16: one block of 4 warps per (b, h, 64-row query tile); warp w owns
// query rows 16w .. 16w + 15 of the tile, and each thread rows g, g + 8 of
// those (g = lane / 4).  At D = Dv <= 64 the registers are held to 128 a
// thread so that four blocks share an SM.
template <int D, int Dv>
__global__ void __launch_bounds__(kTcThreads, D + Dv <= 128 ? 4 : 1)
    fa_fwd_tc_kernel(const Params p) {
  constexpr int LD = D + 8, kTile = kBlock * LD;
  constexpr int kStage = kTile + kBlock * (Dv + 8);  // one k and one v tile
  // causal: the last query tiles see the most keys, so they go first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlock;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / p.group;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [kBlock][LD]  q
  bf16* kv = qs + kTile;                         // 2 stages x (k, v)

  const int q1 = min(p.S, q0 + kBlock);
  int k_begin, k_end;
  kv_range(p, q0, q1, &k_begin, &k_end);
  const int n = (k_end - k_begin + kBlock - 1) / kBlock;
  auto load_kv = [&](int i) {  // key tile i -> stage i % 2
    const int k0 = k_begin + i * kBlock, rows = min(kBlock, p.T - k0);
    bf16* dst = kv + (i & 1) * kStage;
    cp_tile<D, kBlock>(dst, p.k, p.sk, b, hk, k0, rows);
    cp_tile<Dv, kBlock>(dst + kTile, p.v, p.sv, b, hk, k0, rows);
  };
  cp_tile<D, kBlock>(qs, p.q, p.sq, b, h, q0, q1 - q0);
  if (n > 0) load_kv(0);
  cp_async_commit();

  const float scale2 = p.scale * kLog2e;  // scores in log2 units
  const int row = q0 + warp * 16 + g;     // this thread's rows: row, row + 8
  float o[Dv / 8][4] = {};
  float m[2] = {kNegInf2, kNegInf2}, l[2] = {0.f, 0.f};

  for (int i = 0; i < n; ++i) {
    if (i + 1 < n) load_kv(i + 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile i (and q) have landed
    __syncthreads();
    const int k0 = k_begin + i * kBlock;
    const bf16* ks = kv + (i & 1) * kStage;

    float s[kBlock / 8][4] = {};
    mma_abt<D, kBlock>(s, qs + warp * 16 * LD, ks, lane);
    const bool full = all_visible(p, q0, kBlock, k0, kBlock);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kBlock / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = full || visible(p, row + 8 * (e >> 1),
                                        k0 + 8 * j + 2 * t + (e & 1));
        s[j][e] = ok ? s[j][e] * scale2 : kNegInf2;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // the 4 lanes of a quad share a row
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = fast_exp2(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < kBlock / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = fast_exp2(s[j][e] - m[e >> 1]);
        l[e >> 1] += s[j][e];  // this lane's part of the row sum
      }
#pragma unroll
    for (int nn = 0; nn < Dv / 8; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nn][e] *= alpha[e >> 1];
    mma_split_xb<Dv, kBlock>(o, s, ks + kTile, lane);
    __syncthreads();  // stage i % 2 is free for tile i + 2
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int qp = row + 8 * r;
    if (qp >= p.S) continue;
    const float L = fmaxf(l[r], 1e-30f);
    bf16* orow = static_cast<bf16*>(p.out) + row_off(p.so, b, h, qp);
#pragma unroll
    for (int nn = 0; nn < Dv / 8; ++nn)
      *reinterpret_cast<__nv_bfloat162*>(orow + nn * 8 + 2 * t) =
          __floats2bfloat162_rn(o[nn][2 * r] / L, o[nn][2 * r + 1] / L);
    if (t == 0)
      p.lse[(static_cast<long long>(b) * p.H + h) * p.S + qp] =
          (m[r] + log2f(L)) * kLn2;
  }
}

template <int D, int Dv>
cudaError_t run(const Params& p, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (D * kLdT + kBlock * (D + 1) +
                                       kBlock * (Dv + 1) + kBlock * kLdT);
  const dim3 grid((p.S + kBlock - 1) / kBlock, p.H, p.B);
  note_kernel("fa_fwd_kernel<float, %d, %d>", D, Dv);
  return launch(fa_fwd_kernel<float, D, Dv>, grid, smem, p, stream);
}

template <int D, int Dv>
cudaError_t run_tc(const Params& p, cudaStream_t stream) {
  // q, then 2 stages x (k, v)
  const size_t smem = sizeof(bf16) * kBlock * (3 * (D + 8) + 2 * (Dv + 8));
  const dim3 grid((p.S + kBlock - 1) / kBlock, p.H, p.B);
  note_kernel("fa_fwd_tc_kernel<%d, %d>", D, Dv);
  return launch(fa_fwd_tc_kernel<D, Dv>, grid, smem, p, stream, kTcThreads);
}

}  // namespace

// dtype: 0 float32 (CUDA cores), 1 bfloat16 (tensor cores); (head_dim,
// v_head_dim) one of by_head_dims' pairs.  Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int fa_fwd_launch(const fa::Params* p, int dtype, int head_dim,
                             int v_head_dim, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(by_head_dims(head_dim, v_head_dim,
                                           [&](auto d, auto dv) {
        return run<decltype(d)::value, decltype(dv)::value>(*p, s);
      }));
    case 1:
      return static_cast<int>(by_head_dims(head_dim, v_head_dim,
                                           [&](auto d, auto dv) {
        return run_tc<decltype(d)::value, decltype(dv)::value>(*p, s);
      }));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The instantiation fa_fwd_launch last launched.
extern "C" const char* fa_fwd_last_kernel() { return fa::last_kernel; }
