// FA-2 backward for Hopper (sm_90a): the dq kernel and the dk/dv kernel.
//
// Replace the Pallas TPU kernels in src/repro/kernels/flash_attention/
// kernel.py (launched by _bwd_bhsd):
//  * _fa_bwd_dq_kernel   -> fa_bwd_dq_tc_kernel (bf16) and
//    fa_bwd_dq_kernel (fp32): one block per (b, h, 64-row query tile),
//    looping over key tiles: dq = sum_j ds_ij k_j;
//  * _fa_bwd_dkdv_kernel -> fa_bwd_dkdv_tc_kernel (bf16) and
//    fa_bwd_dkdv_kernel (fp32): one block per (b, kv head, 64-row key
//    tile), looping over the g query heads of the group and their query
//    tiles: dk = sum_i ds_ij^T q_i, dv = sum_i p_ij^T do_i.  The group sum
//    happens inside the block, so dk/dv are written once per kv head; the
//    TPU kernel wrote a (B, H, T, D) fp32 intermediate and summed the
//    group outside (kernel.py:370).
// Both recompute p = exp(s - lse) from the forward's lse and take
// ds = p * (do.v - delta) * scale with delta = rowsum(do * out) computed
// outside (kernel.py:293).  Outputs are fp32, cast by the caller.
//
// At opt-1.3b's shape (B=4, S=2048, H=32, D=64, causal, bf16) dq is
// 1.0e11 FLOP and dk/dv 1.4e11 FLOP: both bound by operations on this
// card, so bf16 inputs run on the tensor cores (see flash_attn.cuh).
//  * dq: S = Q K^T and dP = dO V^T by mma.sync, dS formed on the
//    accumulators in registers, then dQ += dS K with dS as its hi and lo
//    bf16 halves (4 products where unsplit ones take 3).  The block's Q,
//    dO, lse and delta arrive once; K and V stream through two cp.async
//    stages.
//  * dk/dv: S^T = K Q^T and dP^T = V dO^T, P^T and dS^T on the
//    accumulators, then dV += P^T dO and dK += dS^T Q with P^T and dS^T
//    split (6 products where unsplit ones take 4).  Q, dO, lse and delta
//    stream through two cp.async stages.
// fp32 inputs run on the CUDA cores.

#include "flash_attn.cuh"

namespace {

using namespace fa;

template <typename T, int D, int Dv>
__global__ void __launch_bounds__(kThreads) fa_bwd_dq_kernel(const Params p) {
  constexpr int DJ = D / 16;
  const int q0 = blockIdx.x * kBlock, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / p.group;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                      // [D][kLdT]      q^T
  float* dot = qt + D * kLdT;            // [Dv][kLdT]     do^T
  float* ks = dot + Dv * kLdT;           // [kBlock][D+1]  k
  float* vs = ks + kBlock * (D + 1);     // [kBlock][Dv+1] v
  float* dst = vs + kBlock * (Dv + 1);   // [kBlock][kLdT] ds^T
  float* lse_s = dst + kBlock * kLdT;    // [kBlock]
  float* dlt_s = lse_s + kBlock;         // [kBlock]

  const int q1 = min(p.S, q0 + kBlock);
  load_tile_t<T, D>(qt, p.q, p.sq, b, h, q0, q1 - q0);
  load_tile_t<T, Dv>(dot, p.dout, p.sdo, b, h, q0, q1 - q0);
  const long long row0 = (static_cast<long long>(b) * p.H + h) * p.S + q0;
  for (int r = threadIdx.x; r < kBlock; r += kThreads) {
    lse_s[r] = q0 + r < p.S ? p.lse[row0 + r] : 0.f;
    dlt_s[r] = q0 + r < p.S ? p.delta[row0 + r] : 0.f;
  }
  __syncthreads();
  float lse_r[4], dlt_r[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lse_r[i] = lse_s[ty * 4 + i];
    dlt_r[i] = dlt_s[ty * 4 + i];
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) acc[i][jj] = 0.f;
  }
  int k_begin, k_end;
  kv_range(p, q0, q1, &k_begin, &k_end);

  for (int k0 = k_begin; k0 < k_end; k0 += kBlock) {
    __syncthreads();
    const int rows = min(kBlock, p.T - k0);
    load_tile<T, D>(ks, p.k, p.sk, b, hk, k0, rows);
    load_tile<T, Dv>(vs, p.v, p.sv, b, hk, k0, rows);
    __syncthreads();

    float s[4][4] = {}, dp[4][4] = {};
    tile_dot<D>(s, qt, ks, tx, ty);
    tile_dot<Dv>(dp, dot, vs, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pr = visible(p, qp, k0 + tx + 16 * j)
                             ? expf(s[i][j] * p.scale - lse_r[i])
                             : 0.f;
        dst[(tx + 16 * j) * kLdT + ty * 4 + i] =
            pr * (dp[i][j] - dlt_r[i]) * p.scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBlock; ++c) {
      const float4 dv4 = *reinterpret_cast<const float4*>(dst + c * kLdT + ty * 4);
      const float ds[4] = {dv4.x, dv4.y, dv4.z, dv4.w};
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) {
        const float kv = ks[c * (D + 1) + tx + 16 * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][jj] = fmaf(ds[i], kv, acc[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    if (qp >= p.S) continue;
    float* row = p.dq + row_off(p.sdq, b, h, qp);
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) row[tx + 16 * jj] = acc[i][jj];
  }
}

template <typename T, int D, int Dv>
__global__ void __launch_bounds__(kThreads) fa_bwd_dkdv_kernel(const Params p) {
  constexpr int DJ = D / 16, DVJ = Dv / 16;
  const int k0 = blockIdx.x * kBlock, hk = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  extern __shared__ __align__(16) float smem[];
  float* kt = smem;                      // [D][kLdT]      k^T
  float* vt = kt + D * kLdT;             // [Dv][kLdT]     v^T
  float* qs = vt + Dv * kLdT;            // [kBlock][D+1]  q
  float* dos = qs + kBlock * (D + 1);    // [kBlock][Dv+1] do
  float* ps = dos + kBlock * (Dv + 1);   // [kBlock][kLdT] p  (row = query)
  float* dss = ps + kBlock * kLdT;       // [kBlock][kLdT] ds (row = query)
  float* lse_s = dss + kBlock * kLdT;    // [kBlock]
  float* dlt_s = lse_s + kBlock;         // [kBlock]

  const int k1 = min(p.T, k0 + kBlock);
  load_tile_t<T, D>(kt, p.k, p.sk, b, hk, k0, k1 - k0);
  load_tile_t<T, Dv>(vt, p.v, p.sv, b, hk, k0, k1 - k0);
  int q_begin, q_end;
  q_range(p, k0, k1, &q_begin, &q_end);

  float dk[4][DJ] = {}, dv[4][DVJ] = {};

  for (int h = hk * p.group; h < (hk + 1) * p.group; ++h) {
    for (int q0 = q_begin; q0 < q_end; q0 += kBlock) {
      __syncthreads();
      const int rows = min(kBlock, p.S - q0);
      load_tile<T, D>(qs, p.q, p.sq, b, h, q0, rows);
      load_tile<T, Dv>(dos, p.dout, p.sdo, b, h, q0, rows);
      const long long row0 = (static_cast<long long>(b) * p.H + h) * p.S + q0;
      for (int r = threadIdx.x; r < kBlock; r += kThreads) {
        lse_s[r] = r < rows ? p.lse[row0 + r] : 0.f;
        dlt_s[r] = r < rows ? p.delta[row0 + r] : 0.f;
      }
      __syncthreads();

      // transposed products: row i is key k0 + ty*4 + i, column j is
      // query q0 + tx + 16*j
      float st[4][4] = {}, dpt[4][4] = {};
      tile_dot<D>(st, kt, qs, tx, ty);
      tile_dot<Dv>(dpt, vt, dos, tx, ty);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qr = tx + 16 * j;
        const float lse = lse_s[qr], dlt = dlt_s[qr];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pr = visible(p, q0 + qr, k0 + ty * 4 + i)
                               ? expf(st[i][j] * p.scale - lse)
                               : 0.f;
          ps[qr * kLdT + ty * 4 + i] = pr;
          dss[qr * kLdT + ty * 4 + i] = pr * (dpt[i][j] - dlt) * p.scale;
        }
      }
      __syncthreads();

#pragma unroll 2
      for (int r = 0; r < kBlock; ++r) {
        const float4 p4 = *reinterpret_cast<const float4*>(ps + r * kLdT + ty * 4);
        const float4 d4 = *reinterpret_cast<const float4*>(dss + r * kLdT + ty * 4);
        const float pr[4] = {p4.x, p4.y, p4.z, p4.w};
        const float ds[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
        for (int jj = 0; jj < DVJ; ++jj) {
          const float dov = dos[r * (Dv + 1) + tx + 16 * jj];
#pragma unroll
          for (int i = 0; i < 4; ++i) dv[i][jj] = fmaf(pr[i], dov, dv[i][jj]);
        }
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj) {
          const float qv = qs[r * (D + 1) + tx + 16 * jj];
#pragma unroll
          for (int i = 0; i < 4; ++i) dk[i][jj] = fmaf(ds[i], qv, dk[i][jj]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kp = k0 + ty * 4 + i;
    if (kp >= p.T) continue;
    float* krow = p.dk + row_off(p.sdk, b, hk, kp);
    float* vrow = p.dv + row_off(p.sdv, b, hk, kp);
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) krow[tx + 16 * jj] = dk[i][jj];
#pragma unroll
    for (int jj = 0; jj < DVJ; ++jj) vrow[tx + 16 * jj] = dv[i][jj];
  }
}

// bf16: one block of 4 warps per (b, h, 64-row query tile); warp w owns
// query rows 16w .. 16w + 15, each thread rows g, g + 8 of those.  The
// block's q and do tiles, lse and delta arrive once and stay; k and v
// tiles stream through two cp.async stages over the key range the query
// tile sees.  dS = P (dP - delta) is formed on the S and dP accumulators,
// which are the A fragments of dQ += dS K, so dS never leaves the
// registers.  At D = Dv <= 64 the registers are held to 128 a thread so
// that four blocks share an SM.
template <int D, int Dv>
__global__ void __launch_bounds__(kTcThreads, D + Dv <= 128 ? 4 : 1)
    fa_bwd_dq_tc_kernel(const Params p) {
  constexpr int LD = D + 8, LDV = Dv + 8;
  constexpr int kTile = kBlock * LD, kVTile = kBlock * LDV;
  constexpr int kStage = kTile + kVTile;  // one k and one v tile
  // causal: the last query tiles see the most keys, so they go first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlock;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / p.group;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [kBlock][LD]   q
  bf16* dos = qs + kTile;                        // [kBlock][LDV]  do
  bf16* kv = dos + kVTile;                       // 2 stages x (k, v)
  float* rows_s = reinterpret_cast<float*>(kv + 2 * kStage);
                                                 // lse, delta [kBlock]

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
  cp_tile<Dv, kBlock>(dos, p.dout, p.sdo, b, h, q0, q1 - q0);
  const long long row0 = (static_cast<long long>(b) * p.H + h) * p.S + q0;
  for (int r = threadIdx.x; r < kBlock; r += kTcThreads) {
    const bool in = q0 + r < p.S;
    cp_async4(rows_s + r, in ? p.lse + row0 + r : p.lse, in ? 4 : 0);
    cp_async4(rows_s + kBlock + r, in ? p.delta + row0 + r : p.delta,
              in ? 4 : 0);
  }
  cp_async_commit();
  if (n > 0) load_kv(0);
  cp_async_commit();
  cp_async_wait<1>();  // q, do, lse and delta have landed
  __syncthreads();

  const float scale2 = p.scale * kLog2e;  // scores in log2 units
  const int row = q0 + warp * 16 + g;     // this thread's rows: row, row + 8
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse2[r] = rows_s[row - q0 + 8 * r] * kLog2e;
    dlt[r] = rows_s[kBlock + row - q0 + 8 * r];
  }
  // dq accumulates sum_j (p * (dp - delta)) k; the scale is applied once
  // at the end
  float dq[D / 8][4] = {};

  for (int i = 0; i < n; ++i) {
    if (i + 1 < n) load_kv(i + 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile i has landed
    __syncthreads();
    const int k0 = k_begin + i * kBlock;
    const bf16* ks = kv + (i & 1) * kStage;
    const bf16* vs = ks + kTile;

    float s[kBlock / 8][4] = {}, dp[kBlock / 8][4] = {};
    mma_abt<D, kBlock>(s, qs + warp * 16 * LD, ks, lane);
    mma_abt<Dv, kBlock>(dp, dos + warp * 16 * LDV, vs, lane);
    const bool full = all_visible(p, q0, kBlock, k0, kBlock);
#pragma unroll
    for (int j = 0; j < kBlock / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const bool ok = full || visible(p, row + 8 * r,
                                        k0 + 8 * j + 2 * t + (e & 1));
        const float pr =
            ok ? fast_exp2(fmaf(s[j][e], scale2, -lse2[r])) : 0.f;
        s[j][e] = pr * (dp[j][e] - dlt[r]);
      }
    mma_split_xb<D, kBlock>(dq, s, ks, lane);
    __syncthreads();  // stage i % 2 is free for tile i + 2
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = row + 8 * r;
    if (qp >= p.S) continue;
    float* qrow = p.dq + row_off(p.sdq, b, h, qp);
#pragma unroll
    for (int nn = 0; nn < D / 8; ++nn)
      *reinterpret_cast<float2*>(qrow + nn * 8 + 2 * t) =
          make_float2(dq[nn][2 * r] * p.scale, dq[nn][2 * r + 1] * p.scale);
  }
}

// Query rows a bf16 dk/dv block takes at a time: 64; 32 where the dK and
// dV accumulators alone ((D + Dv) / 2 registers a thread) pass 96; 16 at
// (192, 128), whose 160 accumulator registers spill at 32 rows.
template <int D, int Dv>
constexpr int kDkdvQRows = D + Dv > 256 ? 16 : D + Dv > 192 ? 32 : 64;

// bf16: one block of 4 warps per (b, kv head, 64-row key tile); warp w
// owns key rows 16w .. 16w + 15, each thread rows g, g + 8 of those.
// Query tiles are kDkdvQRows rows.
template <int D, int Dv>
__global__ void __launch_bounds__(kTcThreads)
    fa_bwd_dkdv_tc_kernel(const Params p) {
  constexpr int LD = D + 8, LDV = Dv + 8, kQ = kDkdvQRows<D, Dv>;
  constexpr int kTile = kBlock * LD, kQTile = kQ * LD;
  constexpr int kQStage = kQ * (LD + LDV);  // one q and one do tile
  const int k0 = blockIdx.x * kBlock, hk = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [kBlock][LD]   k
  bf16* vs = ks + kTile;                         // [kBlock][LDV]  v
  bf16* qdo = vs + kBlock * LDV;                 // 2 stages x (q, do)
  float* rows_s = reinterpret_cast<float*>(qdo + 2 * kQStage);
                                                 // 2 stages x (lse, delta)

  const int k1 = min(p.T, k0 + kBlock);
  int q_begin, q_end;
  q_range(p, k0, k1, &q_begin, &q_end);
  const int nq = max(0, (q_end - q_begin + kQ - 1) / kQ);  // tiles a head
  const int n = nq * p.group;
  auto load_q = [&](int i) {  // query tile i of the group -> stage i % 2
    const int h = hk * p.group + i / nq, q0 = q_begin + (i % nq) * kQ;
    const int rows = min(kQ, p.S - q0);
    bf16* dst = qdo + (i & 1) * kQStage;
    cp_tile<D, kQ>(dst, p.q, p.sq, b, h, q0, rows);
    cp_tile<Dv, kQ>(dst + kQTile, p.dout, p.sdo, b, h, q0, rows);
    const long long row0 = (static_cast<long long>(b) * p.H + h) * p.S + q0;
    float* dst_rows = rows_s + (i & 1) * 2 * kQ;
    for (int r = threadIdx.x; r < kQ; r += kTcThreads) {
      cp_async4(dst_rows + r, r < rows ? p.lse + row0 + r : p.lse,
                r < rows ? 4 : 0);
      cp_async4(dst_rows + kQ + r, r < rows ? p.delta + row0 + r : p.delta,
                r < rows ? 4 : 0);
    }
  };
  cp_tile<D, kBlock>(ks, p.k, p.sk, b, hk, k0, k1 - k0);
  cp_tile<Dv, kBlock>(vs, p.v, p.sv, b, hk, k0, k1 - k0);
  if (n > 0) load_q(0);
  cp_async_commit();

  const float scale2 = p.scale * kLog2e;  // scores in log2 units
  const int key = k0 + warp * 16 + g;     // this thread's keys: key, key + 8
  // dk accumulates sum_i (p * (dp - delta))^T q; the scale is applied once
  // at the end
  float dk[D / 8][4] = {}, dv[Dv / 8][4] = {};

  for (int i = 0; i < n; ++i) {
    if (i + 1 < n) load_q(i + 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile i (and k, v) have landed
    __syncthreads();
    const int q0 = q_begin + (i % nq) * kQ;
    const bf16* qs = qdo + (i & 1) * kQStage;
    const bf16* dos = qs + kQTile;
    const float* lse_s = rows_s + (i & 1) * 2 * kQ;
    const float* dlt_s = lse_s + kQ;

    // transposed products: row = key, column = query
    float st[kQ / 8][4] = {}, dpt[kQ / 8][4] = {};
    mma_abt<D, kQ>(st, ks + warp * 16 * LD, qs, lane);
    mma_abt<Dv, kQ>(dpt, vs + warp * 16 * LDV, dos, lane);
    const bool full = all_visible(p, q0, kQ, k0, kBlock);
#pragma unroll
    for (int j = 0; j < kQ / 8; ++j) {
      const int c = 8 * j + 2 * t;  // this lane's columns c, c + 1
      const float2 lse = *reinterpret_cast<const float2*>(lse_s + c);
      const float2 dlt = *reinterpret_cast<const float2*>(dlt_s + c);
      const float lse2[2] = {lse.x * kLog2e, lse.y * kLog2e};
      const float dl[2] = {dlt.x, dlt.y};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok =
            full || visible(p, q0 + c + (e & 1), key + 8 * (e >> 1));
        const float pr =
            ok ? fast_exp2(fmaf(st[j][e], scale2, -lse2[e & 1])) : 0.f;
        st[j][e] = pr;
        dpt[j][e] = pr * (dpt[j][e] - dl[e & 1]);
      }
    }
    mma_split_xb<Dv, kQ>(dv, st, dos, lane);
    mma_split_xb<D, kQ>(dk, dpt, qs, lane);
    __syncthreads();  // stage i % 2 is free for tile i + 2
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kp = key + 8 * r;
    if (kp >= p.T) continue;
    float* krow = p.dk + row_off(p.sdk, b, hk, kp);
    float* vrow = p.dv + row_off(p.sdv, b, hk, kp);
#pragma unroll
    for (int nn = 0; nn < D / 8; ++nn)
      *reinterpret_cast<float2*>(krow + nn * 8 + 2 * t) =
          make_float2(dk[nn][2 * r] * p.scale, dk[nn][2 * r + 1] * p.scale);
#pragma unroll
    for (int nn = 0; nn < Dv / 8; ++nn)
      *reinterpret_cast<float2*>(vrow + nn * 8 + 2 * t) =
          make_float2(dv[nn][2 * r], dv[nn][2 * r + 1]);
  }
}

template <int D, int Dv>
cudaError_t run_dq(const Params& p, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((D + Dv) * kLdT + kBlock * (D + 1) +
                       kBlock * (Dv + 1) + kBlock * kLdT + 2 * kBlock);
  const dim3 grid((p.S + kBlock - 1) / kBlock, p.H, p.B);
  note_kernel("fa_bwd_dq_kernel<float, %d, %d>", D, Dv);
  return launch(fa_bwd_dq_kernel<float, D, Dv>, grid, smem, p, stream);
}

template <int D, int Dv>
cudaError_t run_dq_tc(const Params& p, cudaStream_t stream) {
  // q, do; 2 stages x (k, v) in bf16, then lse and delta in fp32
  const size_t smem = sizeof(bf16) * 3 * kBlock * (D + 8 + Dv + 8) +
                      sizeof(float) * 2 * kBlock;
  const dim3 grid((p.S + kBlock - 1) / kBlock, p.H, p.B);
  note_kernel("fa_bwd_dq_tc_kernel<%d, %d>", D, Dv);
  return launch(fa_bwd_dq_tc_kernel<D, Dv>, grid, smem, p, stream,
                kTcThreads);
}

template <int D, int Dv>
cudaError_t run_dkdv(const Params& p, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((D + Dv) * kLdT + kBlock * (D + 1) +
                       kBlock * (Dv + 1) + 2 * kBlock * kLdT + 2 * kBlock);
  const dim3 grid((p.T + kBlock - 1) / kBlock, p.K, p.B);
  note_kernel("fa_bwd_dkdv_kernel<float, %d, %d>", D, Dv);
  return launch(fa_bwd_dkdv_kernel<float, D, Dv>, grid, smem, p, stream);
}

template <int D, int Dv>
cudaError_t run_dkdv_tc(const Params& p, cudaStream_t stream) {
  constexpr int kQ = kDkdvQRows<D, Dv>;
  // k, v; 2 stages x (q, do) in bf16, then 2 stages x (lse, delta) in fp32
  const size_t smem = sizeof(bf16) * (kBlock + 2 * kQ) * (D + 8 + Dv + 8) +
                      sizeof(float) * 4 * kQ;
  const dim3 grid((p.T + kBlock - 1) / kBlock, p.K, p.B);
  note_kernel("fa_bwd_dkdv_tc_kernel<%d, %d>", D, Dv);
  return launch(fa_bwd_dkdv_tc_kernel<D, Dv>, grid, smem, p, stream,
                kTcThreads);
}

// Launch dq (or dk/dv) through run_fp32 for dtype 0 and run_bf16 for 1.
template <typename F32, typename BF16>
int dispatch(int dtype, int head_dim, int v_head_dim, F32 run_fp32,
             BF16 run_bf16) {
  switch (dtype) {
    case 0: return static_cast<int>(
        by_head_dims(head_dim, v_head_dim, run_fp32));
    case 1: return static_cast<int>(
        by_head_dims(head_dim, v_head_dim, run_bf16));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 float32 (CUDA cores), 1 bfloat16 (tensor cores); (head_dim,
// v_head_dim) one of by_head_dims' pairs.  Each returns cudaGetLastError()
// after its launch (0 on success).
extern "C" int fa_bwd_dq_launch(const fa::Params* p, int dtype, int head_dim,
                                int v_head_dim, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(
      dtype, head_dim, v_head_dim,
      [&](auto d, auto dv) {
        return run_dq<decltype(d)::value, decltype(dv)::value>(*p, s);
      },
      [&](auto d, auto dv) {
        return run_dq_tc<decltype(d)::value, decltype(dv)::value>(*p, s);
      });
}

extern "C" int fa_bwd_dkdv_launch(const fa::Params* p, int dtype,
                                  int head_dim, int v_head_dim,
                                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(
      dtype, head_dim, v_head_dim,
      [&](auto d, auto dv) {
        return run_dkdv<decltype(d)::value, decltype(dv)::value>(*p, s);
      },
      [&](auto d, auto dv) {
        return run_dkdv_tc<decltype(d)::value, decltype(dv)::value>(*p, s);
      });
}

// The instantiation fa_bwd_dq_launch or fa_bwd_dkdv_launch last launched.
extern "C" const char* fa_bwd_last_kernel() { return fa::last_kernel; }
