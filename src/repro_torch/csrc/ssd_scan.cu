// Mamba2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/ssd_scan/kernel.py::_ssd_kernel   (ssd_bhcq)
// Same function.  For one (batch b, head h), with head h reading B/C group
// h / (heads / groups), the chunks of Q positions carry a (p x n) fp32
// state S, zero at the start.  Per chunk c, all in fp32:
//   cs   = inclusive cumsum of dt * A                 (Q,)
//   y    = ((C B^T) o L o dt_j) x + exp(cs_i) (C S_c^T),
//          L[i,j] = exp(cs_i - cs_j) for i >= j, 0 otherwise
//   S_c+1 = exp(cs_last) S_c + (x o w)^T B,   w_j = dt_j exp(cs_last - cs_j)
// and y is written in x's dtype.  L is formed from the difference
// cs_i - cs_j (<= 0), never as exp(cs_i) * exp(-cs_j): cs is a sum of up
// to Q negative terms and exp(-cs_j) would overflow fp32.  cs is summed in
// fp64 and rounded once, so every kernel here and the plain version get it
// bit for bit.  Positions >= s read as dt = x = B = C = 0, which leaves the
// state unchanged, and their rows of y are not written, so the caller makes
// no padded copy.  Every tensor is read through its strides (the last
// dimension dense), so the model's (b, s, h, p) activations go in as
// transposed views.
//
// What bounds it on an H100: at mamba2-130m's prefill (b 8, s 4096, h 24,
// p 64, n 128, Q 128, bf16) the scan moves 221 MB (0.066 ms at 3.35 TB/s)
// and does 6.44e10 FLOP (0.065 ms at the 989 TFLOP/s of bf16 tensor cores,
// 0.96 ms at the 67 TFLOP/s of fp32 CUDA cores).
//
// Design: the recurrence is split in the standard three parts of SSD,
// whose arithmetic equals the sequential scan, so that the card fills
// (6,144 chunk tiles at that shape instead of 192 sequential blocks):
//  1. ssd_chunk_state: per (b, h, chunk) but the last, the chunk's state
//     increment (x o w)^T B and its decay exp(cs_last), to an fp32 scratch;
//  2. ssd_state_pass: per (b, h) and float4 of the state, the short pass in
//     chunk order S_c+1 = exp(cs_last,c) S_c + dS_c, in place, leaving the
//     state that enters each chunk (loads issued eight chunks ahead);
//  3. ssd_chunk_out: per (b, h, chunk), y = diagonal + off-diagonal term,
//     written in x's dtype.
// bf16 inputs run every product on the tensor cores (mma.sync m16n8k16,
// fp32 accumulators, fragments by ldmatrix from tiles that arrive by
// cp.async, rows padded by 8 elements): C B^T is one exact bf16 product;
// each other product has one exact bf16 operand (x, B or C) and one fp32
// operand (x o w, the masked and scaled C B^T, S) taken as hi = bf16(v) and
// lo = bf16(v - hi), two products, which keeps it within 2^-17 of fp32.
// The score tile of step 3 is never stored: its accumulators are the A
// fragments of the product with x.  fp32 inputs take the same three steps
// on the CUDA cores, with k-major operands in shared memory and float4
// fragments (a bf16 split of fp32 data would break the fp32 bars).
// A chunk's tile is 128 rows (Q <= 128); p and n are padded with zeros to
// the bf16 kernels' instantiated widths (32, 64, 128).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_attn.cuh"

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
  float* states;    // (b, h, nchunks - 1, p, n) fp32 scratch
  float* decay;     // (b, h, nchunks) fp32 scratch: exp(cs_last)
  long long seqlen;
  long long xb, xh, xs;  // element strides; the last dimension is dense
  long long db, dh, ds;
  long long bb, bg, bs;
  long long cb, cg, cs;
  long long yb, yh, ys;
  int batch, heads, groups, p, n, chunk, nchunks;
};

}  // namespace ssd

namespace {

using ssd::Params;
using bf16 = __nv_bfloat16;

constexpr int kRows = 128;        // rows of a chunk tile (Q <= 128)
constexpr int kMaxSmem = 232448;  // opt-in shared memory of a block
constexpr int kRowTile = 32;      // fp32 output kernel: rows a block

// Where one (b, h, chunk) reads and writes: element offsets of its first
// row in x, B, C and y, and its dt.
struct Tile {
  long long x, B, C, y;
  const float* dt;
  float A;
  int valid;  // rows of the chunk inside the sequence
  int bh;
};

__device__ __forceinline__ Tile tile_of(const Params& P, int c, int bh) {
  const int b = bh / P.heads, h = bh % P.heads;
  const int grp = h / (P.heads / P.groups);
  const long long c0 = static_cast<long long>(c) * P.chunk;
  const long long left = P.seqlen - c0;
  Tile t;
  t.valid = static_cast<int>(left < P.chunk ? left : P.chunk);
  t.A = P.A[h];
  t.bh = bh;
  t.dt = P.dt + b * P.db + h * P.dh + c0 * P.ds;
  t.x = b * P.xb + h * P.xh + c0 * P.xs;
  t.B = b * P.bb + grp * P.bg + c0 * P.bs;
  t.C = b * P.cb + grp * P.cg + c0 * P.cs;
  t.y = b * P.yb + h * P.yh + c0 * P.ys;
  return t;
}

template <typename T>
__device__ __forceinline__ const T* at(const void* base, long long off) {
  return static_cast<const T*>(base) + off;
}

// dts[j] = dt of row j (0 past the chunk's valid rows), j < kRows; then,
// by warp 0, cs = inclusive cumsum of dts * A over the 128 rows, summed
// in fp64 and rounded once: cs_j is the correctly rounded prefix sum
// whatever the order, so every kernel and the plain version (which does
// the same) get the same cs bit for bit.  Rows past `valid` add 0, so
// cs[kRows - 1] is the chunk's last cumsum.  Ends with a barrier.
__device__ __forceinline__ void chunk_cumsum(const Tile& t, long long ds,
                                             float* dts, float* cs) {
  for (int j = threadIdx.x; j < kRows; j += blockDim.x)
    dts[j] = j < t.valid ? t.dt[j * ds] : 0.0f;
  __syncthreads();
  if (threadIdx.x < 32) {
    constexpr int kPer = kRows / 32;
    const int lane = threadIdx.x;
    double loc[kPer];
    double run = 0.0;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      run += static_cast<double>(dts[lane * kPer + e] * t.A);
      loc[e] = run;
    }
    double incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double o = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += o;
    }
    double excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.0;
#pragma unroll
    for (int e = 0; e < kPer; ++e)
      cs[lane * kPer + e] = static_cast<float>(excl + loc[e]);
  }
  __syncthreads();
}

// cp.async rows [0, rows) x wpad elements of a bf16 tile into dst (row
// pitch ld), zero-filling rows past `valid` and columns past `width`.
__device__ __forceinline__ void cp_rows(bf16* dst, int ld, const bf16* src,
                                        long long stride, int rows,
                                        int valid, int width, int wpad) {
  const int cpr = wpad / 8;
  for (int i = threadIdx.x; i < rows * cpr; i += blockDim.x) {
    const int r = i / cpr, c = (i - r * cpr) * 8;
    const bool in = r < valid && c < width;
    fa::cp_async16(dst + r * ld + c, in ? src + r * stride + c : src,
                   in ? 16 : 0);
  }
}

// ---- step 1, bf16: dS = (x o w)^T B on the tensor cores ------------------
//
// 4 warps; warp w takes the 16-row m-tiles w, w+4 of the p rows.  The A
// operand (x o w)^T is read from x's [j][pp] tile by ldmatrix.trans and
// scaled by w in registers, then split into hi + lo; B's [j][nn] tile is
// the B operand, read across rows by ldmatrix.trans.
template <int P, int N>
__global__ void __launch_bounds__(128)
    ssd_chunk_state_tc_kernel(const Params prm) {
  constexpr int LDX = P + 8, LDB = N + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // [kRows][LDX]
  bf16* bs = xs + kRows * LDX;                   // [kRows][LDB]
  float* dts = reinterpret_cast<float*>(bs + kRows * LDB);
  float* cs = dts + kRows;
  float* w = cs + kRows;

  const Tile t = tile_of(prm, blockIdx.x, blockIdx.y);
  const int r16 = (t.valid + 15) / 16 * 16;
  cp_rows(xs, LDX, at<bf16>(prm.x, t.x), prm.xs, r16, t.valid, prm.p, P);
  cp_rows(bs, LDB, at<bf16>(prm.B, t.B), prm.bs, r16, t.valid, prm.n, N);
  fa::cp_async_commit();
  chunk_cumsum(t, prm.ds, dts, cs);
  const float last = cs[kRows - 1];
  for (int j = threadIdx.x; j < kRows; j += blockDim.x)
    w[j] = dts[j] * expf(last - cs[j]);
  if (threadIdx.x == 0)
    prm.decay[static_cast<size_t>(t.bh) * prm.nchunks + blockIdx.x] =
        expf(last);
  fa::cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = lane & 7, r8 = ((lane >> 3) & 1) * 8, c8 = (lane >> 4) * 8;
  const int g = lane >> 2, q = lane & 3;
  float* out = prm.states +
               (static_cast<size_t>(t.bh) * (prm.nchunks - 1) + blockIdx.x) *
                   prm.p * prm.n;
  for (int mt = warp; mt < P / 16 && mt * 16 < prm.p; mt += 4) {
    float acc[N / 8][4] = {};
    for (int kk = 0; kk < r16 / 16; ++kk) {
      const int k0 = kk * 16 + 2 * q;
      const float w0 = w[k0], w1 = w[k0 + 1], w8 = w[k0 + 8], w9 = w[k0 + 9];
      unsigned af[4], hi[4], lo[4];
      fa::ldsm_x4_t(af, xs + (kk * 16 + c8 + r) * LDX + mt * 16 + r8);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 v =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&af[e]));
        const float wa = e < 2 ? w0 : w8, wb = e < 2 ? w1 : w9;
        fa::split2(v.x * wa, v.y * wb, hi[e], lo[e]);
      }
#pragma unroll
      for (int np = 0; np < N / 16; ++np) {
        unsigned bf[4];
        fa::ldsm_x4_t(bf, bs + (kk * 16 + r + r8) * LDB + np * 16 + c8);
        fa::mma_bf16(acc[2 * np], hi, bf[0], bf[1]);
        fa::mma_bf16(acc[2 * np + 1], hi, bf[2], bf[3]);
        fa::mma_bf16(acc[2 * np], lo, bf[0], bf[1]);
        fa::mma_bf16(acc[2 * np + 1], lo, bf[2], bf[3]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < N / 8; ++nt) {
      const int nn = nt * 8 + 2 * q;
      if (nn >= prm.n) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int pp = mt * 16 + g + 8 * half;
        if (pp < prm.p)
          *reinterpret_cast<float2*>(out + pp * prm.n + nn) =
              make_float2(acc[nt][2 * half], acc[nt][2 * half + 1]);
      }
    }
  }
}

// ---- step 1, fp32: the same on the CUDA cores ----------------------------
//
// 256 threads; x o w ([j][pp]) and B ([j][nn]) staged as fp32, both k-major
// (rows j); each thread owns 4 x 8 outputs and reads them as one float4
// of x o w and two of B per j.
__global__ void __launch_bounds__(256)
    ssd_chunk_state_f32_kernel(const Params prm) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int p = prm.p, n = prm.n;
  float* xw = reinterpret_cast<float*>(smem_raw);  // [kRows][p]
  float* bs = xw + kRows * p;                      // [kRows][n]
  float* dts = bs + kRows * n;
  float* cs = dts + kRows;

  const Tile t = tile_of(prm, blockIdx.x, blockIdx.y);
  chunk_cumsum(t, prm.ds, dts, cs);
  const float last = cs[kRows - 1];
  if (threadIdx.x == 0)
    prm.decay[static_cast<size_t>(t.bh) * prm.nchunks + blockIdx.x] =
        expf(last);
  const float* xg = at<float>(prm.x, t.x);
  const float* bg = at<float>(prm.B, t.B);
  for (int i = threadIdx.x; i < t.valid * (p / 4); i += blockDim.x) {
    const int j = i / (p / 4), c = (i - j * (p / 4)) * 4;
    const float wj = dts[j] * expf(last - cs[j]);
    float4 v = *reinterpret_cast<const float4*>(xg + j * prm.xs + c);
    v.x *= wj, v.y *= wj, v.z *= wj, v.w *= wj;
    *reinterpret_cast<float4*>(xw + j * p + c) = v;
  }
  for (int i = threadIdx.x; i < t.valid * (n / 4); i += blockDim.x) {
    const int j = i / (n / 4), c = (i - j * (n / 4)) * 4;
    *reinterpret_cast<float4*>(bs + j * n + c) =
        *reinterpret_cast<const float4*>(bg + j * prm.bs + c);
  }
  __syncthreads();

  float* out = prm.states +
               (static_cast<size_t>(t.bh) * (prm.nchunks - 1) + blockIdx.x) *
                   p * n;
  const int tn = n / 8;
  for (int tile = threadIdx.x; tile < (p / 4) * tn; tile += blockDim.x) {
    const int pp = (tile / tn) * 4, nn = (tile % tn) * 8;
    float acc[4][8] = {};
    for (int j = 0; j < t.valid; ++j) {
      const float4 a = *reinterpret_cast<const float4*>(xw + j * p + pp);
      const float4 b0 = *reinterpret_cast<const float4*>(bs + j * n + nn);
      const float4 b1 = *reinterpret_cast<const float4*>(bs + j * n + nn + 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 8; ++v) acc[u][v] = fmaf(av[u], bv[v], acc[u][v]);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float* o = out + (pp + u) * n + nn;
      *reinterpret_cast<float4*>(o) =
          make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
      *reinterpret_cast<float4*>(o + 4) =
          make_float4(acc[u][4], acc[u][5], acc[u][6], acc[u][7]);
    }
  }
}

// ---- step 2: the state pass, in chunk order -------------------------------
//
// states[c] holds dS_c on entry and S_c+1 = exp(cs_last,c) S_c + dS_c on
// exit (S_0 = 0), so it then holds the state that enters chunk c + 1.
// One thread a float4 of the (p x n) state; the loads of eight chunks are
// issued before their updates.
__global__ void __launch_bounds__(256) ssd_state_pass_kernel(const Params prm) {
  const int pn4 = prm.p * prm.n / 4;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= pn4) return;
  const int steps = prm.nchunks - 1;
  float4* st = reinterpret_cast<float4*>(
                   prm.states + static_cast<size_t>(blockIdx.y) * steps *
                                    prm.p * prm.n) + e;
  const float* dec = prm.decay + static_cast<size_t>(blockIdx.y) *
                                     prm.nchunks;
  float4 S = make_float4(0.f, 0.f, 0.f, 0.f);
  constexpr int kAhead = 8;
  for (int c0 = 0; c0 < steps; c0 += kAhead) {
    float4 d[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
      if (c0 + u < steps) d[u] = st[static_cast<size_t>(c0 + u) * pn4];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (c0 + u >= steps) break;
      const float a = dec[c0 + u];
      S.x = S.x * a + d[u].x;
      S.y = S.y * a + d[u].y;
      S.z = S.z * a + d[u].z;
      S.w = S.w * a + d[u].w;
      st[static_cast<size_t>(c0 + u) * pn4] = S;
    }
  }
}

// ---- step 3, bf16: y = ((C B^T) o L o dt_j) x + exp(cs_i) (C S_c^T) ------
//
// 8 warps, 16 rows each.  C stays in shared memory; a second region holds
// first S (read as fp32 and split into hi + lo bf16 tiles) for the
// off-diagonal term, then B and x for the diagonal term, which keeps a
// block at 88 KB (p 64, n 128) so that two share an SM and one loads
// while the other computes.  The diagonal term goes in two 64-column blocks of the score
// tile (the second only for rows that see it): C B^T by mma_abt, masked
// and scaled in registers, then multiplied into y as hi + lo by
// mma_split_xb.
template <int P, int N>
__global__ void __launch_bounds__(256, P <= 64 ? 2 : 1)
    ssd_chunk_out_tc_kernel(const Params prm) {
  constexpr int LDC = N + 8, LDX = P + 8;
  constexpr int kRegion = (2 * P * LDC > kRows * (LDC + LDX))
                              ? 2 * P * LDC : kRows * (LDC + LDX);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* csm = reinterpret_cast<bf16*>(smem_raw);  // C [kRows][LDC]
  bf16* region = csm + kRows * LDC;
  bf16* shi = region;                             // S hi [P][LDC], then
  bf16* slo = shi + P * LDC;                      // S lo [P][LDC]; or
  bf16* bsm = region;                             // B [kRows][LDC]
  bf16* xsm = bsm + kRows * LDC;                  // x [kRows][LDX]
  float* dts = reinterpret_cast<float*>(region + kRegion);
  float* cs = dts + kRows;
  float* ecs = cs + kRows;

  const int c = blockIdx.x;
  const Tile t = tile_of(prm, c, blockIdx.y);
  const int r16 = (t.valid + 15) / 16 * 16, r64 = (t.valid + 63) / 64 * 64;
  auto load_bx = [&]() {
    cp_rows(bsm, LDC, at<bf16>(prm.B, t.B), prm.bs, r64, t.valid, prm.n, N);
    cp_rows(xsm, LDX, at<bf16>(prm.x, t.x), prm.xs, r64, t.valid, prm.p, P);
  };
  cp_rows(csm, LDC, at<bf16>(prm.C, t.C), prm.cs, r16, t.valid, prm.n, N);
  if (c == 0) load_bx();      // no state enters the first chunk
  fa::cp_async_commit();
  if (c > 0) {  // the state entering chunk c, split into hi + lo
    const float* S = prm.states +
                     (static_cast<size_t>(t.bh) * (prm.nchunks - 1) + c - 1) *
                         prm.p * prm.n;
    for (int i = threadIdx.x; i < P * (N / 4); i += blockDim.x) {
      const int pp = i / (N / 4), nn = (i - pp * (N / 4)) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (pp < prm.p && nn < prm.n)
        v = *reinterpret_cast<const float4*>(S + pp * prm.n + nn);
      uint2 h2, l2;
      fa::split2(v.x, v.y, h2.x, l2.x);
      fa::split2(v.z, v.w, h2.y, l2.y);
      *reinterpret_cast<uint2*>(shi + pp * LDC + nn) = h2;
      *reinterpret_cast<uint2*>(slo + pp * LDC + nn) = l2;
    }
  }
  chunk_cumsum(t, prm.ds, dts, cs);
  for (int j = threadIdx.x; j < kRows; j += blockDim.x) ecs[j] = expf(cs[j]);
  fa::cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int i0 = warp * 16;
  const bool active = i0 < t.valid;
  float y[P / 8][4] = {};
  if (c > 0) {
    if (active) {
      fa::mma_abt<N, P>(y, csm + i0 * LDC, shi, lane);
      fa::mma_abt<N, P>(y, csm + i0 * LDC, slo, lane);
      const float e0 = ecs[i0 + g], e1 = ecs[i0 + g + 8];
#pragma unroll
      for (int nt = 0; nt < P / 8; ++nt) {
        y[nt][0] *= e0;
        y[nt][1] *= e0;
        y[nt][2] *= e1;
        y[nt][3] *= e1;
      }
    }
    __syncthreads();          // S is read: the region takes B and x
    load_bx();
    fa::cp_async_commit();
    fa::cp_async_wait<0>();
    __syncthreads();
  }

  if (active) {
    const int ia = i0 + g, ib = ia + 8;
    const float ca = cs[ia], cb = cs[ib];
#pragma unroll
    for (int jb = 0; jb < kRows; jb += 64) {
      if (jb >= r64 || jb > i0 + 15) break;
      float s[8][4] = {};
      fa::mma_abt<N, 64>(s, csm + i0 * LDC, bsm + jb * LDC, lane);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = jb + nt * 8 + 2 * q + e;
          const float cj = cs[j], dj = dts[j];
          s[nt][e] = j <= ia ? s[nt][e] * (expf(ca - cj) * dj) : 0.0f;
          s[nt][2 + e] = j <= ib ? s[nt][2 + e] * (expf(cb - cj) * dj) : 0.0f;
        }
      }
      fa::mma_split_xb<P, 64>(y, s, xsm + jb * LDX, lane);
    }
    bf16* yg = static_cast<bf16*>(prm.y) + t.y;
#pragma unroll
    for (int nt = 0; nt < P / 8; ++nt) {
      const int pp = nt * 8 + 2 * q;
      if (pp >= prm.p) continue;
      if (ia < t.valid)
        *reinterpret_cast<__nv_bfloat162*>(yg + ia * prm.ys + pp) =
            __floats2bfloat162_rn(y[nt][0], y[nt][1]);
      if (ib < t.valid)
        *reinterpret_cast<__nv_bfloat162*>(yg + ib * prm.ys + pp) =
            __floats2bfloat162_rn(y[nt][2], y[nt][3]);
    }
  }
}

// ---- step 3, fp32: the same on the CUDA cores -----------------------------
//
// A block takes kRowTile rows of a chunk.  It forms the score tile G (rows
// x the columns they see) from C^T and B^T staged k-major, masks and
// scales it into G^T, then reuses B's space for x and S^T and forms
// y = G x + exp(cs_i) C S^T; each thread owns 4 x 4 outputs, fed by
// float4 fragments.
__global__ void __launch_bounds__(256)
    ssd_chunk_out_f32_kernel(const Params prm) {
  constexpr int RT = kRowTile, LDT = RT + 4, LDB = kRows + 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int p = prm.p, n = prm.n;
  float* ct = reinterpret_cast<float*>(smem_raw);  // C^T [n][LDT]
  float* gt = ct + n * LDT;                        // G^T [kRows][LDT]
  float* region = gt + kRows * LDT;   // B^T [n][LDB], then x, S^T
  const int region_floats = max(n * LDB, kRows * p + n * p);
  float* dts = region + region_floats;
  float* cs = dts + kRows;

  const int tiles = (prm.chunk + RT - 1) / RT;
  const int c = blockIdx.x / tiles, i0 = (blockIdx.x % tiles) * RT;
  const Tile t = tile_of(prm, c, blockIdx.y);
  if (i0 >= t.valid) return;
  const int rows = min(RT, t.valid - i0);
  const int jmax = i0 + rows;  // columns the tile's rows see
  chunk_cumsum(t, prm.ds, dts, cs);

  const float* cg = at<float>(prm.C, t.C);
  const float* bg = at<float>(prm.B, t.B);
  for (int i = threadIdx.x; i < RT * (n / 4); i += blockDim.x) {
    const int ii = i % RT, k = (i / RT) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (ii < rows)
      v = *reinterpret_cast<const float4*>(cg + (i0 + ii) * prm.cs + k);
    ct[k * LDT + ii] = v.x;
    ct[(k + 1) * LDT + ii] = v.y;
    ct[(k + 2) * LDT + ii] = v.z;
    ct[(k + 3) * LDT + ii] = v.w;
  }
  for (int i = threadIdx.x; i < kRows * (n / 4); i += blockDim.x) {
    const int j = i % kRows, k = (i / kRows) * 4;
    if (j >= jmax) continue;
    const float4 v = *reinterpret_cast<const float4*>(bg + j * prm.bs + k);
    region[k * LDB + j] = v.x;
    region[(k + 1) * LDB + j] = v.y;
    region[(k + 2) * LDB + j] = v.z;
    region[(k + 3) * LDB + j] = v.w;
  }
  __syncthreads();

  // G^T[j][ii] = (C B^T)[i0 + ii][j] * exp(cs_i - cs_j) * dt_j, j <= i
  const int ti = threadIdx.x % (RT / 4), tj = threadIdx.x / (RT / 4);
  for (int j4 = tj * 4; j4 < jmax; j4 += (256 / (RT / 4)) * 4) {
    float acc[4][4] = {};
    for (int k = 0; k < n; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(ct + k * LDT + ti * 4);
      const float4 b = *reinterpret_cast<const float4*>(region + k * LDB + j4);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(av[u], bv[v], acc[u][v]);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + ti * 4 + u;
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int j = j4 + v;
        gt[j * LDT + ti * 4 + u] =
            j <= i ? acc[u][v] * (expf(cs[i] - cs[j]) * dts[j]) : 0.0f;
      }
    }
  }
  __syncthreads();

  // region <- x [j][pp] (j < jmax) and S^T [k][pp]
  float* xs = region;
  float* st = region + kRows * p;
  const float* xg = at<float>(prm.x, t.x);
  for (int i = threadIdx.x; i < jmax * (p / 4); i += blockDim.x) {
    const int j = i / (p / 4), cc = (i - j * (p / 4)) * 4;
    *reinterpret_cast<float4*>(xs + j * p + cc) =
        *reinterpret_cast<const float4*>(xg + j * prm.xs + cc);
  }
  if (c > 0) {
    const float* S = prm.states +
                     (static_cast<size_t>(t.bh) * (prm.nchunks - 1) + c - 1) *
                         p * n;
    for (int i = threadIdx.x; i < p * (n / 4); i += blockDim.x) {
      const int pp = i % p, k = (i / p) * 4;
      const float4 v = *reinterpret_cast<const float4*>(S + pp * n + k);
      st[k * p + pp] = v.x;
      st[(k + 1) * p + pp] = v.y;
      st[(k + 2) * p + pp] = v.z;
      st[(k + 3) * p + pp] = v.w;
    }
  }
  __syncthreads();

  float* yg = static_cast<float*>(prm.y) + t.y;
  for (int tp = tj; tp < p / 4; tp += 256 / (RT / 4)) {
    float acc[4][4] = {}, off[4][4] = {};
    for (int j = 0; j < jmax; ++j) {
      const float4 a = *reinterpret_cast<const float4*>(gt + j * LDT + ti * 4);
      const float4 b = *reinterpret_cast<const float4*>(xs + j * p + tp * 4);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(av[u], bv[v], acc[u][v]);
    }
    if (c > 0) {
      for (int k = 0; k < n; ++k) {
        const float4 a =
            *reinterpret_cast<const float4*>(ct + k * LDT + ti * 4);
        const float4 b = *reinterpret_cast<const float4*>(st + k * p + tp * 4);
        const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v)
            off[u][v] = fmaf(av[u], bv[v], off[u][v]);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int ii = ti * 4 + u;
      if (ii >= rows) continue;
      const float e = expf(cs[i0 + ii]);
      *reinterpret_cast<float4*>(yg + (i0 + ii) * prm.ys + tp * 4) =
          make_float4(acc[u][0] + e * off[u][0], acc[u][1] + e * off[u][1],
                      acc[u][2] + e * off[u][2], acc[u][3] + e * off[u][3]);
    }
  }
}

// ---- launchers ------------------------------------------------------------

template <typename Kernel>
cudaError_t run(Kernel kernel, dim3 grid, int threads, size_t smem,
                const Params& P, cudaStream_t stream) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, threads, smem, stream>>>(P);
  return cudaGetLastError();
}

cudaError_t state_pass(const Params& P, cudaStream_t stream) {
  const int pn4 = P.p * P.n / 4;
  return run(ssd_state_pass_kernel, dim3((pn4 + 255) / 256,
                                         P.batch * P.heads),
             256, 0, P, stream);
}

template <int Pw, int Nw>
cudaError_t launch_tc(const Params& P, cudaStream_t stream) {
  const int bh = P.batch * P.heads;
  if (P.nchunks > 1) {
    const size_t s1 = sizeof(bf16) * kRows * ((Pw + 8) + (Nw + 8)) +
                      3 * kRows * sizeof(float);
    cudaError_t e = run(ssd_chunk_state_tc_kernel<Pw, Nw>,
                        dim3(P.nchunks - 1, bh), 128, s1, P, stream);
    if (e != cudaSuccess) return e;
    e = state_pass(P, stream);
    if (e != cudaSuccess) return e;
  }
  const int s_tiles = 2 * Pw * (Nw + 8), bx = kRows * (Nw + Pw + 16);
  const size_t s3 = sizeof(bf16) * (kRows * (Nw + 8) +
                                    (s_tiles > bx ? s_tiles : bx)) +
                    3 * kRows * sizeof(float);
  return run(ssd_chunk_out_tc_kernel<Pw, Nw>, dim3(P.nchunks, bh), 256, s3,
             P, stream);
}

template <int Pw>
cudaError_t launch_tc_n(const Params& P, cudaStream_t stream) {
  if (P.n <= 32) return launch_tc<Pw, 32>(P, stream);
  if (P.n <= 64) return launch_tc<Pw, 64>(P, stream);
  return launch_tc<Pw, 128>(P, stream);
}

cudaError_t launch_f32(const Params& P, cudaStream_t stream) {
  const int bh = P.batch * P.heads;
  if (P.nchunks > 1) {
    const size_t s1 = sizeof(float) * (kRows * (P.p + P.n) + 2 * kRows);
    cudaError_t e = run(ssd_chunk_state_f32_kernel, dim3(P.nchunks - 1, bh),
                        256, s1, P, stream);
    if (e != cudaSuccess) return e;
    e = state_pass(P, stream);
    if (e != cudaSuccess) return e;
  }
  const int bt = P.n * (kRows + 4), xst = kRows * P.p + P.n * P.p;
  const int region = bt > xst ? bt : xst;
  const size_t s3 = sizeof(float) * (P.n * (kRowTile + 4) +
                                     kRows * (kRowTile + 4) + region +
                                     2 * kRows);
  const int tiles = (P.chunk + kRowTile - 1) / kRowTile;
  return run(ssd_chunk_out_f32_kernel, dim3(P.nchunks * tiles, bh), 256, s3,
             P, stream);
}

}  // namespace

// dtype 0: x, B, C and y fp32; 1: bf16.  dt and A are fp32.  p and n are
// multiples of 8 and at most 128, the chunk at most 128, groups divide
// heads; every pointer and row stride is 16-byte aligned; states and
// decay hold (b, h, nchunks - 1, p, n) and (b, h, nchunks) fp32 when
// nchunks > 1 (the wrapper checks and allocates all of it).  Launches
// steps 1-3 (step 3 alone for a single chunk) and returns
// cudaGetLastError() after them (0 on success).
extern "C" int ssd_scan_launch(const ssd::Params* P, int dtype,
                               void* stream) {
  if (P->batch <= 0 || P->heads <= 0 || P->seqlen <= 0) return 0;
  if (P->p > kRows || P->n > kRows || P->chunk > kRows || P->chunk <= 0 ||
      P->p % 8 || P->n % 8 || P->groups <= 0 || P->heads % P->groups ||
      P->nchunks != (P->seqlen + P->chunk - 1) / P->chunk)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (dtype) {
    case 0:
      e = launch_f32(*P, st);
      break;
    case 1:
      e = P->p <= 32   ? launch_tc_n<32>(*P, st)
          : P->p <= 64 ? launch_tc_n<64>(*P, st)
                       : launch_tc_n<128>(*P, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(e);
}
