// Paged split-KV flash-decoding for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/decode.py::_flash_decode_kernel
// (launched by _decode_bkgd / flash_decode_paged) and the jnp merge of its
// split partials (decode.py:308-317).  Same function: for every (sequence
// b, KV head h) an online softmax over the pages of b's block table, for
// the C*g query rows of that head (GQA group g, C teacher-forced chunk
// rows, chunk-major: row r is chunk index r / g and sees seq_len + r / g
// positions, optionally only the last `window`), the pages cut into
// splits that run as separate blocks and are merged by the logsumexp
// rescale.  One call is two launches and nothing else: the split kernel
// (q read through its (B, C, H, D) strides) and the merge kernel, which
// writes the (B, C, H, Dv) fp32 output; with one split the split kernel
// writes the output itself.
//
// What bounds it on an H100: page bytes.  The work per page is about
// 2*(D+Dv)*C*g FLOP against bs*K*(D+Dv)*bytes read, a handful of FLOP per
// byte, far under the card's ~295 FLOP/byte ridge.  At B=8 sequences of
// 2048 tokens, K=4, D=128 in bf16 a call must read ~33.5 MB of pages,
// ~10 us at 3.35 TB/s.
//
// Design:
//  * grid (splits, B*K, ceil(C*g / 64)); the wrapper picks the split count
//    from the shapes alone (B, K, the table width and the SM count, never
//    seq_lens), so the grid is static; each block walks only the live
//    pages of its split (the bounds come from seq_len, C and window), so
//    dead pages are never read, and a split with no live page emits
//    (m = -1e30, l = 0, acc = 0), which vanishes in the merge;
//  * the split's block-table entries are read ahead into shared memory,
//    then pages stream in through a cp.async ring (16-byte copies, each
//    stage several pages, kept in the pages' own dtype; int8 scales by
//    4-byte copies), one barrier a stage;
//  * bf16 pages (the serving path) with heads up to 128 wide run on the
//    tensor cores: 4 warps as m-tiles of 16 query rows x token groups, q
//    split once into three bf16 tiles (hi + mid + lo hold fp32's 24
//    bits), S = q K^T and P V by mma.sync m16n8k16 with P split the same
//    way, so every product keeps fp32's precision; the online softmax
//    lives on the accumulators;
//  * fp32 and int8 pages, and wider bf16 heads, run on the CUDA cores: 8
//    warps as row groups x token groups, a quad of lanes per token, each
//    lane a 16-byte fragment of the key converted (int8 times its scale)
//    in registers, dot products against q rows in shared memory summed by
//    shuffles, the online softmax and P.V accumulators in registers
//    (lanes over Dv);
//  * a block's token groups are merged through shared memory once, at its
//    end; scores are kept in log2 units (exp2 on the special-function
//    unit), masked scores are -1e30, never -inf, and a fully masked row
//    adds nothing, so a slot with seq_len == 0 yields 0, not NaN.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_attn.cuh"

namespace fd {

// Mirror of _DecodeParams in kernels/flash_attention/decode.py.  Outside
// the anonymous namespace: the extern "C" launcher takes it.
struct Params {
  const float* q;             // (B, C, H, D) fp32, strides below
  const void* k_pages;        // (P, bs, K, D)
  const void* v_pages;        // (P, bs, K, Dv)
  const float* k_scale;       // (P, bs, K) or null
  const float* v_scale;       // (P, bs, K) or null
  const int* block_tables;    // (B, nb)
  const int* seq_lens;        // (B,)
  float* m_part;              // (B, K, S, CG)
  float* l_part;              // (B, K, S, CG)
  float* acc_part;            // (B, K, S, CG, Dv)
  float* out;                 // (B, C, H, Dv) contiguous
  long long qb, qc, qh;       // q's element strides; the last is 1
  int B, K, C, group, D, Dv, bs, nb, pps, num_splits, window;
  float scale;
};

}  // namespace fd

namespace {

using fd::Params;

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 8;                     // rows a warp owns
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
constexpr int kStages = 3;                          // cp.async ring
constexpr int kMaxVpl = 4;                          // Dv <= 128

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

// Bytes of one staged key row: padded so that a row spans an odd number
// of half bank-rows (64 bytes), so that the four 16-byte fragments the
// quads of two neighbouring tokens read (one 8-lane phase of a 16-byte
// load) fall in eight distinct bank groups.  Value rows are read across
// lanes, contiguously, and need no pad.
__host__ __device__ inline int key_row_bytes(int D, int item) {
  const int chunks = D * item / 16;
  return (chunks + ((4 - chunks % 8) + 8) % 8) * 16;
}

struct Layout {           // byte offsets into dynamic shared memory
  int stage, k, v, ks, vs, q, bt, total;
};

__host__ __device__ inline Layout layout(int D, int Dv, int item, int nt,
                                         int rows, int pps, int tg) {
  Layout L;
  L.k = 0;
  L.v = nt * key_row_bytes(D, item);
  L.ks = L.v + nt * Dv * item;
  L.vs = L.ks + (item == 1 ? nt * 4 : 0);
  L.stage = L.vs + (item == 1 ? nt * 4 : 0);
  int ring = kStages * L.stage;
  const int merge = tg * rows * (Dv + 2) * 4;   // token groups' partials
  if (merge > ring) ring = merge;
  L.q = (ring + 15) / 16 * 16;
  L.bt = L.q + rows * D * 4;
  L.total = L.bt + (pps * 4 + 15) / 16 * 16;
  return L;
}

// Reads split si's block-table entries into bt_s (ahead of, and
// alongside, the sequence's length), returns that length, and leaves in
// *p0 and *p1 the pages of the split that some row may attend to
// (decode.py _page_live): at most seq_len + C - 1 positions in and, with
// a window, not left of it.  Those are the only pages the block reads.
__device__ __forceinline__ int split_pages(const Params& p, int b, int si,
                                           int* bt_s, int* p0, int* p1) {
  const int* bt = p.block_tables + static_cast<size_t>(b) * p.nb;
  const int s0 = si * p.pps, s1 = min(p.nb, s0 + p.pps);
  for (int i = threadIdx.x; i < s1 - s0; i += blockDim.x) bt_s[i] = bt[s0 + i];
  const int seq_len = p.seq_lens[b];
  const int hi = min((seq_len + p.C - 1 + p.bs - 1) / p.bs, p.nb);
  const int lo = p.window > 0 && seq_len - p.window > 0
                     ? (seq_len - p.window) / p.bs : 0;
  *p0 = max(lo, s0);
  *p1 = min(hi, s1);
  return seq_len;
}

// The block's partials of each row, laid out as red[(k * stride + r) *
// ld + {0: m, 1: l, 2 + d: acc}] for k < parts, combined by the logsumexp
// rescale (maxima in log2 units) and written as the split's (m, l, acc)
// or, with one split, as the output row.
__device__ __forceinline__ void finish_rows(const Params& p, const float* red,
                                            int parts, int stride, int ld,
                                            int rows, int r0, int si) {
  const int CG = p.C * p.group, h = blockIdx.y % p.K, b = blockIdx.y / p.K;
  const int S = p.num_splits;
  const size_t part = (static_cast<size_t>(blockIdx.y) * S + si) * CG + r0;
  for (int idx = threadIdx.x; idx < rows * p.Dv; idx += blockDim.x) {
    const int r = idx / p.Dv, d = idx - r * p.Dv;
    float M = kNegInf;
    for (int k = 0; k < parts; ++k)
      M = fmaxf(M, red[(k * stride + r) * ld]);
    float lt = 0.f, at = 0.f;
    for (int k = 0; k < parts; ++k) {
      const float* src = red + (k * stride + r) * ld;
      const float a = fa::fast_exp2(src[0] - M);
      lt = fmaf(src[1], a, lt);
      at = fmaf(src[2 + d], a, at);
    }
    if (S == 1) {           // the only split: write the output
      const int rr = r0 + r, c = rr / p.group;
      const int head = h * p.group + rr % p.group;
      p.out[((static_cast<size_t>(b) * p.C + c) * (p.K * p.group) + head) *
                p.Dv + d] = at / fmaxf(lt, 1e-30f);
    } else {
      p.acc_part[(part + r) * p.Dv + d] = at;
      if (d == 0) {
        p.m_part[part + r] = M;
        p.l_part[part + r] = lt;
      }
    }
  }
}

template <typename T, int RG>
__global__ void __launch_bounds__(kThreads, 2)
    flash_decode_split_kernel(const Params p, const int sp) {
  constexpr int TG = kWarps / RG;         // token groups
  constexpr int kItem = sizeof(T);
  constexpr int E = 16 / kItem;           // elements in a 16-byte fragment
  constexpr bool kQuant = kItem == 1;
  extern __shared__ __align__(16) unsigned char smem[];

  const int si = blockIdx.x, b = blockIdx.y / p.K, h = blockIdx.y % p.K;
  const int CG = p.C * p.group;
  const int r0 = blockIdx.z * kRowsPerBlock;
  const int rows = min(kRowsPerBlock, CG - r0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rg = warp % RG, tg = warp / RG;
  const int quad = lane & 3, tok8 = lane >> 2;
  const int NT = sp * p.bs;
  const Layout L = layout(p.D, p.Dv, kItem, NT, rows, p.pps, TG);
  const int row_k = key_row_bytes(p.D, kItem), row_v = p.Dv * kItem;
  float* q_s = reinterpret_cast<float*>(smem + L.q);
  int* bt_s = reinterpret_cast<int*>(smem + L.bt);

  int p0, p1;
  const int seq_len = split_pages(p, b, si, bt_s, &p0, &p1);
  const int npages = max(0, p1 - p0);
  const int nst = (npages + sp - 1) / sp;
  const int* bt_live = bt_s + (p0 - si * p.pps);  // the live pages' entries

  // q rows of this block (fp32, 16-byte loads)
  const int dq4 = p.D / 4;
  for (int i = tid; i < rows * dq4; i += kThreads) {
    const int r = i / dq4, d = (i - r * dq4) * 4, rr = r0 + r;
    const float* src = p.q + b * p.qb + (rr / p.group) * p.qc +
                       (h * p.group + rr % p.group) * p.qh + d;
    *reinterpret_cast<float4*>(q_s + r * p.D + d) =
        *reinterpret_cast<const float4*>(src);
  }
  __syncthreads();

  const unsigned char* kg = static_cast<const unsigned char*>(p.k_pages);
  const unsigned char* vg = static_cast<const unsigned char*>(p.v_pages);
  const int kch = p.D * kItem / 16, vch = p.Dv * kItem / 16;
  // each thread copies one fixed 16-byte fragment of every `step`-th token
  const int per = kch + vch, step = kThreads / per;
  const int my_ch = tid % per, my_tok = tid / per;
  const bool my_k = my_ch < kch;
  const size_t src_off = my_k ? my_ch * 16 : (my_ch - kch) * 16;
  const int dst_off = my_k ? L.k + my_ch * 16 : L.v + (my_ch - kch) * 16;
  const int dst_row = my_k ? row_k : row_v;
  const unsigned char* src_base = my_k ? kg : vg;
  const size_t src_row = (my_k ? p.D : p.Dv) * kItem;
  auto issue = [&](int st) {
    unsigned char* base = smem + (st % kStages) * L.stage;
    const int first = st * sp;
    const int ntok = min(sp, npages - first) * p.bs;
    if (my_tok < step) {
      for (int tok = my_tok; tok < ntok; tok += step) {
        const int pg = tok / p.bs, t = tok - pg * p.bs;
        const size_t row =
            (static_cast<size_t>(bt_live[first + pg]) * p.bs + t) * p.K + h;
        fa::cp_async16(base + dst_off + tok * dst_row,
                       src_base + row * src_row + src_off, 16);
      }
    }
    if (kQuant) {
      for (int i = tid; i < 2 * ntok; i += kThreads) {
        const int tok = i >> 1, pg = tok / p.bs, t = tok - pg * p.bs;
        const size_t row =
            (static_cast<size_t>(bt_live[first + pg]) * p.bs + t) * p.K + h;
        if (i & 1)
          fa::cp_async4(base + L.vs + tok * 4, p.v_scale + row, 4);
        else
          fa::cp_async4(base + L.ks + tok * 4, p.k_scale + row, 4);
      }
    }
  };

  // per warp: rows rg + RG*i (i < kRowsPerWarp) of the block
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kMaxVpl];
  int valid[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
    const int r = rg + RG * i;
    valid[i] = r < rows ? seq_len + (r0 + r) / p.group : 0;  // 0: no row
#pragma unroll
    for (int j = 0; j < kMaxVpl; ++j) acc[i][j] = 0.f;
  }
  const int vpl = (p.Dv + 31) / 32;
  const float scale2 = p.scale * fa::kLog2e;   // scores in log2 units

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nst) issue(s);
    fa::cp_async_commit();
  }
  for (int st = 0; st < nst; ++st) {
    fa::cp_async_wait<kStages - 2>();
    __syncthreads();        // stage st landed; stage st-1 is free
    if (st + kStages - 1 < nst) issue(st + kStages - 1);
    fa::cp_async_commit();

    const unsigned char* base = smem + (st % kStages) * L.stage;
    const int ntok = min(sp, npages - st * sp) * p.bs;
    const int pos0 = (p0 + st * sp) * p.bs;
    for (int t0 = tg * 8; t0 < ntok; t0 += 8 * TG) {
      const int tok = t0 + tok8;
      const bool in = tok < ntok;
      float s[kRowsPerWarp];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) s[i] = 0.f;
      if (in) {
        const unsigned char* krow = base + L.k + tok * row_k;
        for (int c = quad; c < kch; c += 4) {
          alignas(16) T raw[E];
          *reinterpret_cast<uint4*>(raw) =
              *reinterpret_cast<const uint4*>(krow + c * 16);
          float kf[E];
#pragma unroll
          for (int e = 0; e < E; ++e) kf[e] = to_float(raw[e]);
#pragma unroll
          for (int i = 0; i < kRowsPerWarp; ++i) {
            if (rg + RG * i >= rows) continue;
            const float* qr = q_s + (rg + RG * i) * p.D + c * E;
            float a = s[i];
#pragma unroll
            for (int e = 0; e < E; e += 4) {
              const float4 qv = *reinterpret_cast<const float4*>(qr + e);
              a = fmaf(qv.x, kf[e], a);
              a = fmaf(qv.y, kf[e + 1], a);
              a = fmaf(qv.z, kf[e + 2], a);
              a = fmaf(qv.w, kf[e + 3], a);
            }
            s[i] = a;
          }
        }
      }
      const int pos = pos0 + tok;
      float kscale = 1.f, vscale = 1.f;
      if (kQuant && in) {
        kscale = reinterpret_cast<const float*>(base + L.ks)[tok];
        vscale = reinterpret_cast<const float*>(base + L.vs)[tok];
      }
      float pv[kRowsPerWarp];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        float x = s[i];
        x += __shfl_xor_sync(0xffffffffu, x, 1);
        x += __shfl_xor_sync(0xffffffffu, x, 2);
        bool ok = in && pos < valid[i];
        if (p.window > 0) ok = ok && pos > valid[i] - 1 - p.window;
        x = ok ? x * kscale * scale2 : kNegInf;
        float mx = x;
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
        const float m_new = fmaxf(m[i], mx);
        const float pr = x > 0.5f * kNegInf ? fa::fast_exp2(x - m_new) : 0.f;
        float sum = pr;
        sum += __shfl_xor_sync(0xffffffffu, sum, 4);
        sum += __shfl_xor_sync(0xffffffffu, sum, 8);
        sum += __shfl_xor_sync(0xffffffffu, sum, 16);
        const float alpha = fa::fast_exp2(m[i] - m_new);
        l[i] = l[i] * alpha + sum;
        m[i] = m_new;
#pragma unroll
        for (int j = 0; j < kMaxVpl; ++j) acc[i][j] *= alpha;
        pv[i] = pr * vscale;
      }
      const int nt8 = min(8, ntok - t0);
#pragma unroll
      for (int tt = 0; tt < 8; ++tt) {
        if (tt >= nt8) break;
        const T* vrow =
            reinterpret_cast<const T*>(base + L.v + (t0 + tt) * row_v);
        float vv[kMaxVpl];
#pragma unroll
        for (int j = 0; j < kMaxVpl; ++j) {
          const int d = lane * vpl + j;
          vv[j] = (j < vpl && d < p.Dv) ? to_float(vrow[d]) : 0.f;
        }
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          const float pt = __shfl_sync(0xffffffffu, pv[i], tt * 4);
#pragma unroll
          for (int j = 0; j < kMaxVpl; ++j)
            acc[i][j] = fmaf(pt, vv[j], acc[i][j]);
        }
      }
    }
  }
  fa::cp_async_wait<0>();
  __syncthreads();          // the ring is free: reuse it for the merge

  // token groups' partials -> shared memory, then one (m, l, acc) a row
  float* red = reinterpret_cast<float*>(smem);
  const int ld = p.Dv + 2;
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = rg + RG * i;
    if (r >= rows) continue;
    float* dst = red + (tg * rows + r) * ld;
    if (lane == 0) {
      dst[0] = m[i];
      dst[1] = l[i];
    }
#pragma unroll
    for (int j = 0; j < kMaxVpl; ++j) {
      const int d = lane * vpl + j;
      if (j < vpl && d < p.Dv) dst[2 + d] = acc[i][j];
    }
  }
  __syncthreads();

  finish_rows(p, red, TG, rows, ld, rows, r0, si);
}

// ---- bf16 pages on the tensor cores -------------------------------------
//
// 4 warps as MW m-tiles of 16 query rows x 4/MW token groups.  q arrives
// once, split into three bf16 tiles (hi, mid, lo: together fp32's 24
// bits); pages arrive as bf16 tiles (rows padded by 8 for ldmatrix) in a
// three-stage cp.async ring.  A warp takes 16 tokens at a time: S = q K^T
// as three mma.sync products (m16n8k16, fp32 accumulators), the online
// softmax on the accumulators (rows g and g + 8 of each lane, reduced
// over the quad), then P V with P split in three the same way, its
// accumulators being the A fragments.  Every product is thus exact to
// fp32's precision, summed in fp32.

constexpr int kTcThreads = 128, kTcStages = 3;

struct TcLayout {         // byte offsets into dynamic shared memory
  int stage, v, q, bt, total;
};

__host__ __device__ inline TcLayout tc_layout(int D, int dvp, int nt, int mw,
                                              int pps) {
  TcLayout L;
  const int rows = (nt + 15) / 16 * 16;
  L.v = rows * (D + 8) * 2;
  L.stage = L.v + rows * (dvp + 8) * 2;
  int ring = kTcStages * L.stage;
  const int merge = (4 / mw) * 16 * mw * (dvp + 2) * 4;
  if (merge > ring) ring = merge;
  L.q = (ring + 15) / 16 * 16;
  L.bt = L.q + 3 * 16 * mw * (D + 8) * 2;
  L.total = L.bt + (pps * 4 + 15) / 16 * 16;
  return L;
}

// (x0, x1) -> three bf16 pairs whose sum is (x0, x1) to fp32's precision.
__device__ __forceinline__ void split3(float x0, float x1, unsigned& hi,
                                       unsigned& mid, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const float r0 = x0 - hf.x, r1 = x1 - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(m);
  const __nv_bfloat162 l = __floats2bfloat162_rn(r0 - mf.x, r1 - mf.y);
  hi = *reinterpret_cast<const unsigned*>(&h);
  mid = *reinterpret_cast<const unsigned*>(&m);
  lo = *reinterpret_cast<const unsigned*>(&l);
}

template <int MW, int W>
__global__ void __launch_bounds__(kTcThreads)
    flash_decode_split_tc_kernel(const Params p, const int sp) {
  using bf16 = __nv_bfloat16;
  constexpr int TW = 4 / MW;              // token groups
  constexpr int NO = W / 8;               // n-tiles of the output
  constexpr int LD = W + 8;               // row pitch of q, K and V tiles
  extern __shared__ __align__(16) unsigned char smem[];

  const int si = blockIdx.x, b = blockIdx.y / p.K, h = blockIdx.y % p.K;
  const int CG = p.C * p.group;
  const int r0 = blockIdx.z * kRowsPerBlock;
  const int rows = min(kRowsPerBlock, CG - r0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int mw = warp % MW, tw = warp / MW;
  const int g = lane >> 2, q4 = lane & 3;
  const int r = lane & 7, r8 = ((lane >> 3) & 1) * 8, c8 = (lane >> 4) * 8;
  const int NT = sp * p.bs;
  const TcLayout L = tc_layout(W, W, NT, MW, p.pps);
  bf16* qh = reinterpret_cast<bf16*>(smem + L.q);
  bf16* qm = qh + 16 * MW * LD;
  bf16* ql = qm + 16 * MW * LD;
  int* bt_s = reinterpret_cast<int*>(smem + L.bt);

  int p0, p1;
  const int seq_len = split_pages(p, b, si, bt_s, &p0, &p1);
  const int npages = max(0, p1 - p0);
  const int nst = (npages + sp - 1) / sp;
  const int* bt_live = bt_s + (p0 - si * p.pps);  // the live pages' entries

  // q rows -> hi/mid/lo bf16 tiles, rows past the block's zero
  const int dq4 = W / 4;
  for (int i = tid; i < 16 * MW * dq4; i += kTcThreads) {
    const int rr = i / dq4, d = (i - rr * dq4) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (rr < rows && d < p.D) {
      const int gr = r0 + rr;
      v = *reinterpret_cast<const float4*>(
          p.q + b * p.qb + (gr / p.group) * p.qc +
          (h * p.group + gr % p.group) * p.qh + d);
    }
    uint2 vh, vm, vl;
    split3(v.x, v.y, vh.x, vm.x, vl.x);
    split3(v.z, v.w, vh.y, vm.y, vl.y);
    *reinterpret_cast<uint2*>(qh + rr * LD + d) = vh;
    *reinterpret_cast<uint2*>(qm + rr * LD + d) = vm;
    *reinterpret_cast<uint2*>(ql + rr * LD + d) = vl;
  }
  __syncthreads();

  // each thread copies one fixed 16-byte fragment of every `step`-th row;
  // rows past the stage's tokens (to the next 16) and value columns past
  // Dv are zero-filled
  const bf16* kg = static_cast<const bf16*>(p.k_pages);
  const bf16* vg = static_cast<const bf16*>(p.v_pages);
  const int kch = W / 8, per = 2 * kch, step = kTcThreads / per;
  const int my_ch = tid % per, my_tok = tid / per;
  const bool my_k = my_ch < kch;
  const int col = my_k ? my_ch * 8 : (my_ch - kch) * 8;
  auto issue = [&](int st) {
    unsigned char* base = smem + (st % kTcStages) * L.stage;
    bf16* dst = reinterpret_cast<bf16*>(base + (my_k ? 0 : L.v)) + col;
    const int first = st * sp;
    const int ntok = min(sp, npages - first) * p.bs;
    const int rows16 = (ntok + 15) / 16 * 16;
    if (my_tok >= step) return;
    for (int tok = my_tok; tok < rows16; tok += step) {
      const bool in = tok < ntok && col < (my_k ? p.D : p.Dv);
      const bf16* src = kg;
      if (in) {
        const int pg = tok / p.bs, t = tok - pg * p.bs;
        const size_t row =
            (static_cast<size_t>(bt_live[first + pg]) * p.bs + t) * p.K + h;
        src = my_k ? kg + row * p.D + col : vg + row * p.Dv + col;
      }
      fa::cp_async16(dst + tok * LD, src, in ? 16 : 0);
    }
  };

  const int ra = mw * 16 + g, rb = ra + 8;     // this lane's two rows
  const int valid_a = ra < rows ? seq_len + (r0 + ra) / p.group : 0;
  const int valid_b = rb < rows ? seq_len + (r0 + rb) / p.group : 0;
  const float scale2 = p.scale * fa::kLog2e;   // scores in log2 units
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
  float o[NO][4] = {};

#pragma unroll
  for (int st = 0; st < kTcStages - 1; ++st) {
    if (st < nst) issue(st);
    fa::cp_async_commit();
  }
  for (int st = 0; st < nst; ++st) {
    fa::cp_async_wait<kTcStages - 2>();
    __syncthreads();        // stage st landed; stage st-1 is free
    if (st + kTcStages - 1 < nst) issue(st + kTcStages - 1);
    fa::cp_async_commit();

    const unsigned char* base = smem + (st % kTcStages) * L.stage;
    const bf16* ks = reinterpret_cast<const bf16*>(base);
    const bf16* vs = reinterpret_cast<const bf16*>(base + L.v);
    const int ntok = min(sp, npages - st * sp) * p.bs;
    const int pos0 = (p0 + st * sp) * p.bs;
    for (int t0 = tw * 16; t0 < ntok; t0 += 16 * TW) {
      // q K^T as three independent accumulator chains (hi, mid, lo)
      float s3[3][2][4] = {};
#pragma unroll
      for (int kk = 0; kk < W / 16; ++kk) {
        unsigned bk[4], ah[4], am[4], al[4];
        fa::ldsm_x4(bk, ks + (t0 + r + c8) * LD + kk * 16 + r8);
        const int qoff = (mw * 16 + r + r8) * LD + kk * 16 + c8;
        fa::ldsm_x4(ah, qh + qoff);
        fa::ldsm_x4(am, qm + qoff);
        fa::ldsm_x4(al, ql + qoff);
        fa::mma_bf16(s3[0][0], ah, bk[0], bk[1]);
        fa::mma_bf16(s3[0][1], ah, bk[2], bk[3]);
        fa::mma_bf16(s3[1][0], am, bk[0], bk[1]);
        fa::mma_bf16(s3[1][1], am, bk[2], bk[3]);
        fa::mma_bf16(s3[2][0], al, bk[0], bk[1]);
        fa::mma_bf16(s3[2][1], al, bk[2], bk[3]);
      }
      float sc[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[nt][e] = s3[0][nt][e] + (s3[1][nt][e] + s3[2][nt][e]);
      float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int tok = t0 + nt * 8 + 2 * q4 + (e & 1), pos = pos0 + tok;
          const int vr = e < 2 ? valid_a : valid_b;
          bool ok = tok < ntok && pos < vr;
          if (p.window > 0) ok = ok && pos > vr - 1 - p.window;
          sc[nt][e] = ok ? sc[nt][e] * scale2 : kNegInf;
        }
        mx_a = fmaxf(mx_a, fmaxf(sc[nt][0], sc[nt][1]));
        mx_b = fmaxf(mx_b, fmaxf(sc[nt][2], sc[nt][3]));
      }
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
      const float na = fmaxf(m_a, mx_a), nb = fmaxf(m_b, mx_b);
      const float al_a = fa::fast_exp2(m_a - na), al_b = fa::fast_exp2(m_b - nb);
      m_a = na;
      m_b = nb;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float mm = e < 2 ? na : nb;
          sc[nt][e] = sc[nt][e] > 0.5f * kNegInf
                          ? fa::fast_exp2(sc[nt][e] - mm) : 0.f;
        }
      }
      l_a = l_a * al_a + (sc[0][0] + sc[0][1] + sc[1][0] + sc[1][1]);
      l_b = l_b * al_b + (sc[0][2] + sc[0][3] + sc[1][2] + sc[1][3]);
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        o[n][0] *= al_a;
        o[n][1] *= al_a;
        o[n][2] *= al_b;
        o[n][3] *= al_b;
      }
      unsigned ph[4], pm[4], pl[4];
      split3(sc[0][0], sc[0][1], ph[0], pm[0], pl[0]);
      split3(sc[0][2], sc[0][3], ph[1], pm[1], pl[1]);
      split3(sc[1][0], sc[1][1], ph[2], pm[2], pl[2]);
      split3(sc[1][2], sc[1][3], ph[3], pm[3], pl[3]);
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        unsigned bv[4];
        fa::ldsm_x4_t(bv, vs + (t0 + r + r8) * LD + n * 8 + c8);
        fa::mma_bf16(o[n], ph, bv[0], bv[1]);
        fa::mma_bf16(o[n + 1], ph, bv[2], bv[3]);
        fa::mma_bf16(o[n], pm, bv[0], bv[1]);
        fa::mma_bf16(o[n + 1], pm, bv[2], bv[3]);
        fa::mma_bf16(o[n], pl, bv[0], bv[1]);
        fa::mma_bf16(o[n + 1], pl, bv[2], bv[3]);
      }
    }
  }
  fa::cp_async_wait<0>();
  __syncthreads();          // the ring is free: reuse it for the merge

  l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
  float* red = reinterpret_cast<float*>(smem);
  const int ld = W + 2, stride = 16 * MW;
  float* da = red + (tw * stride + ra) * ld;
  float* db = red + (tw * stride + rb) * ld;
  if (q4 == 0) {
    da[0] = m_a;
    da[1] = l_a;
    db[0] = m_b;
    db[1] = l_b;
  }
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    da[2 + n * 8 + 2 * q4] = o[n][0];
    da[3 + n * 8 + 2 * q4] = o[n][1];
    db[2 + n * 8 + 2 * q4] = o[n][2];
    db[3 + n * 8 + 2 * q4] = o[n][3];
  }
  __syncthreads();
  finish_rows(p, red, TW, stride, ld, rows, r0, si);
}

// out[b, c, h*g + gi, :] = sum_s acc_s 2^(m_s - M) / max(sum_s l_s
// 2^(m_s - M), 1e-30), M = max_s m_s: the logsumexp merge of decode.py,
// with the partials' maxima in log2 units.
__global__ void __launch_bounds__(kThreads)
    flash_decode_merge_kernel(const Params p) {
  const int CG = p.C * p.group;
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= CG * p.Dv) return;
  const int r = idx / p.Dv, d = idx - r * p.Dv;
  const int b = blockIdx.y / p.K, h = blockIdx.y % p.K;
  const int S = p.num_splits;
  const size_t base = static_cast<size_t>(blockIdx.y) * S * CG + r;
  float M = kNegInf;
  for (int s = 0; s < S; ++s) M = fmaxf(M, p.m_part[base + s * CG]);
  float lt = 0.f, at = 0.f;
  for (int s = 0; s < S; ++s) {
    const size_t i = base + s * CG;
    const float a = fa::fast_exp2(p.m_part[i] - M);
    lt += p.l_part[i] * a;
    at += p.acc_part[i * p.Dv + d] * a;
  }
  const int c = r / p.group, head = h * p.group + r % p.group;
  p.out[((static_cast<size_t>(b) * p.C + c) * (p.K * p.group) + head) * p.Dv +
        d] = at / fmaxf(lt, 1e-30f);
}

template <typename T, int RG>
cudaError_t launch_rg(const Params& p, int sp, int smem, cudaStream_t stream) {
  auto kernel = flash_decode_split_kernel<T, RG>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const int CG = p.C * p.group;
  const dim3 grid(p.num_splits, p.B * p.K,
                  (CG + kRowsPerBlock - 1) / kRowsPerBlock);
  kernel<<<grid, kThreads, smem, stream>>>(p, sp);
  return cudaGetLastError();
}

int tc_mw(int CG) {        // m-tiles of 16 rows a block needs
  const int rows = CG < kRowsPerBlock ? CG : kRowsPerBlock;
  return rows <= 16 ? 1 : rows <= 32 ? 2 : 4;
}

int tc_width(int D, int Dv) {   // both widths padded to this one
  const int w = D > Dv ? D : Dv;
  return w <= 32 ? 32 : w <= 64 ? 64 : 128;
}

template <int MW, int W>
cudaError_t launch_tc(const Params& p, int sp, cudaStream_t stream) {
  auto kernel = flash_decode_split_tc_kernel<MW, W>;
  const int smem = tc_layout(W, W, sp * p.bs, MW, p.pps).total;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const int CG = p.C * p.group;
  const dim3 grid(p.num_splits, p.B * p.K,
                  (CG + kRowsPerBlock - 1) / kRowsPerBlock);
  kernel<<<grid, kTcThreads, smem, stream>>>(p, sp);
  return cudaGetLastError();
}

template <int W>
cudaError_t launch_tc_mw(const Params& p, int sp, cudaStream_t stream) {
  switch (tc_mw(p.C * p.group)) {
    case 1: return launch_tc<1, W>(p, sp, stream);
    case 2: return launch_tc<2, W>(p, sp, stream);
    default: return launch_tc<4, W>(p, sp, stream);
  }
}

// Row groups: the fewest (a power of two) that leave a warp at most
// kRowsPerWarp of the block's rows.
int row_groups(int CG) {
  const int rows = CG < kRowsPerBlock ? CG : kRowsPerBlock;
  int rg = 1;
  while (rg < kWarps && (rows + rg - 1) / rg > kRowsPerWarp) rg *= 2;
  return rg;
}

template <typename T>
cudaError_t launch_split(const Params& p, int sp, cudaStream_t stream) {
  const int CG = p.C * p.group;
  const int rows = CG < kRowsPerBlock ? CG : kRowsPerBlock;
  const int rg = row_groups(CG);
  const int smem = layout(p.D, p.Dv, sizeof(T), sp * p.bs, rows, p.pps,
                          kWarps / rg).total;
  switch (rg) {
    case 1: return launch_rg<T, 1>(p, sp, smem, stream);
    case 2: return launch_rg<T, 2>(p, sp, smem, stream);
    case 4: return launch_rg<T, 4>(p, sp, smem, stream);
    default: return launch_rg<T, 8>(p, sp, smem, stream);
  }
}

// bf16 pages on the tensor cores (heads up to 128 wide)?
bool on_tensor_cores(const Params& p, int item) {
  return item == 2 && p.D <= 128 && p.Dv <= 128;
}

// bf16 pages: on the tensor cores up to 128-wide heads, past that on the
// CUDA cores.
cudaError_t launch_bf16(const Params& p, int sp, cudaStream_t stream) {
  if (!on_tensor_cores(p, 2))
    return launch_split<__nv_bfloat16>(p, sp, stream);
  switch (tc_width(p.D, p.Dv)) {
    case 32: return launch_tc_mw<32>(p, sp, stream);
    case 64: return launch_tc_mw<64>(p, sp, stream);
    default: return launch_tc_mw<128>(p, sp, stream);
  }
}

// Pages a stage of the ring holds: about 64 tokens of int8 and CUDA-core
// bf16 pages, 32 of fp32 ones and of the tensor-core kernel's ring, at
// most the split's pages, halved until a block fits twice on an SM
// (113 KB) where it can; 0 when even one page a stage exceeds a block's
// 227 KB.
int stage_pages(const Params& p, int item) {
  constexpr int kTwoBlocks = 113 * 1024, kMaxSmem = 232448;
  const int CG = p.C * p.group;
  const int rows = CG < kRowsPerBlock ? CG : kRowsPerBlock;
  const int tg = kWarps / row_groups(CG);
  const bool tc = on_tensor_cores(p, item);
  const int w = tc_width(p.D, p.Dv);
  auto bytes = [&](int sp) {
    return tc ? tc_layout(w, w, sp * p.bs, tc_mw(CG), p.pps).total
              : layout(p.D, p.Dv, item, sp * p.bs, rows, p.pps, tg).total;
  };
  int sp = (item == 4 || tc ? 32 : 64) / p.bs;
  sp = sp < 1 ? 1 : (sp > p.pps ? p.pps : sp);
  while (sp > 1 && bytes(sp) > kTwoBlocks) sp /= 2;
  return bytes(sp) <= kMaxSmem ? sp : 0;
}

}  // namespace

// page_dtype: 0 float32, 1 bfloat16, 2 int8 (then k_scale/v_scale are
// set).  D and Dv are multiples of 16, Dv <= 128, every q row starts on 16
// bytes (the wrapper checks all of it).  Launches the split kernel and,
// with more than one split, the merge kernel; returns cudaGetLastError()
// after them (0 on success), cudaErrorInvalidValue for shapes whose
// one-page stage exceeds a block's shared memory.
extern "C" int flash_decode_paged_launch(const fd::Params* P, int page_dtype,
                                         void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Params& p = *P;
  if (p.B <= 0 || p.C * p.group <= 0) return 0;
  if (p.D % 16 || p.Dv % 16 || p.Dv > kMaxVpl * 32 || p.num_splits <= 0 ||
      page_dtype < 0 || page_dtype > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int item = page_dtype == 0 ? 4 : page_dtype == 1 ? 2 : 1;
  const int sp = stage_pages(p, item);
  if (sp == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  switch (page_dtype) {
    case 0: e = launch_split<float>(p, sp, s); break;
    case 1: e = launch_bf16(p, sp, s); break;
    default: e = launch_split<int8_t>(p, sp, s); break;
  }
  if (e != cudaSuccess || p.num_splits == 1) return static_cast<int>(e);
  const int CG = p.C * p.group;
  const dim3 grid((CG * p.Dv + kThreads - 1) / kThreads, p.B * p.K);
  flash_decode_merge_kernel<<<grid, kThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}
