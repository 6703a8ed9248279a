// AdamW for Hopper (sm_90a): the clipping norm's sum of squares of one
// leaf, and the fused update of one leaf.
//
// Replaces no TPU kernel: the JAX package's AdamW
// (src/repro/optim/adamw.py::apply_updates) is plain jnp, which XLA fuses
// into a few passes over each leaf.  Run eagerly, the same update in
// PyTorch (kernels/adamw/ref.py, the plain loop) is some twenty
// elementwise kernels a leaf, each writing a full fp32 temporary: about
// 200 bytes a parameter.  These kernels move what the update needs and no
// more.
//
// What bounds them on an H100: device memory.  The update reads p, g, mu
// and nu once and writes p, mu and nu once: 22 bytes a parameter with
// bf16 p and g and fp32 moments, 24 with fp32 g (a sum of microbatch
// gradients).  At opt-1.3b's fc1 leaf (402,653,184 parameters) that is
// 8.86 GB, at least 2.64 ms at 3.35 TB/s.  The norm reads each gradient
// once: 2 or 4 bytes a parameter.  Neither does more than a few dozen
// fp32 operations a parameter, far below the card's ridge.
//
// The math is the plain loop's, operation for operation and in its order,
// all in fp32:
//   g' = g * clip
//   mu' = mu * b1 + (1 - b1) * g'
//   nu' = nu * b2 + (1 - b2) * (g' * g')
//   d = (mu' / bc1) / (sqrt(nu' / bc2) + eps)  [+ wd * p on >= 2-D leaves]
//   p' = p - lr * d
// with each product, sum, quotient and root rounded once, as each of the
// plain loop's PyTorch kernels rounds it: the __f*_rn intrinsics keep
// nvcc from contracting a product and a sum into one FMA, which separate
// kernels never do.  p', mu' and nu' are rounded to their storage types
// once, to nearest even, as copy_ rounds.  So on the card the kernel's
// p, mu and nu equal the plain loop's bit for bit.  lr, clip, bc1 and bc2
// are 0-d device tensors the kernel reads itself: the host never waits
// for the step count or the norm.
//
// Design:
//  * update: lane l of a warp takes the 4-element groups l, 32 + l, ...
//    of the warp's run of kGroups x 32 groups, so each load or store
//    instruction of the warp touches 512 contiguous bytes of an fp32
//    array or 256 of a bf16 one (every sector whole: a store that half
//    fills its sectors ran the int8 dequantize kernel at half speed, see
//    quant8.cu).  A lane issues all its groups' loads before its first
//    store.  The gradient is read through the read-only path; p, mu and
//    nu, which the kernel writes, are not.  One wave of blocks, sized
//    from the SM count and the kernel's occupancy, walks the leaf
//    grid-stride; the n % 4 elements past the last whole group take one
//    thread each.  Every index is 64-bit: granite-3-2b's largest leaf is
//    past 2 GiB in fp32.
//  * norm: a fixed grid (the wrapper's NORM_BLOCKS) walks the leaf
//    grid-stride with 16-byte loads, four in flight a thread, summing
//    squares in fp32; each block reduces its threads in a fixed tree and
//    writes one
//    partial sum.  A second kernel, one block a leaf, adds a leaf's
//    partials in a fixed order.  No atomics: the sum depends on nothing
//    but the leaf's length, and two calls give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kGroups = 2;          // update: 4-element groups a lane a trip
constexpr int kNormLoads = 4;       // norm: 16-byte loads a thread a trip

struct Hyper {
  float lr, clip, bc1, bc2, b1, omb1, b2, omb2, eps, wd;
  int decay;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_float(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_float(float x, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(x);
}

// bf16 bits to fp32: exact, the bf16 value in the high half
__device__ __forceinline__ float lo_bf16(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_bf16(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}
// a in the low half, b in the high half (memory order a, b), each rounded
// to nearest even
__device__ __forceinline__ uint32_t bf16_pair(float a, float b) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(a))) |
         static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(b)))
             << 16;
}

// Four consecutive elements at a 4-element boundary: one 16-byte (fp32)
// or 8-byte (bf16) access.  ``ldg4`` reads through the read-only path.
__device__ __forceinline__ void load4(const float* src, float v[4]) {
  const float4 x = *reinterpret_cast<const float4*>(src);
  v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* src, float v[4]) {
  const uint2 x = *reinterpret_cast<const uint2*>(src);
  v[0] = lo_bf16(x.x), v[1] = hi_bf16(x.x);
  v[2] = lo_bf16(x.y), v[3] = hi_bf16(x.y);
}
__device__ __forceinline__ void ldg4(const float* src, float v[4]) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(src));
  v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
}
__device__ __forceinline__ void ldg4(const __nv_bfloat16* src, float v[4]) {
  const uint2 x = __ldg(reinterpret_cast<const uint2*>(src));
  v[0] = lo_bf16(x.x), v[1] = hi_bf16(x.x);
  v[2] = lo_bf16(x.y), v[3] = hi_bf16(x.y);
}
__device__ __forceinline__ void store4(float* dst, const float v[4]) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst, const float v[4]) {
  *reinterpret_cast<uint2*>(dst) =
      make_uint2(bf16_pair(v[0], v[1]), bf16_pair(v[2], v[3]));
}

// One parameter's step, in the plain loop's order (see the top).
__device__ __forceinline__ void step(float& p, float g, float& m, float& v,
                                     const Hyper& h) {
  g = __fmul_rn(g, h.clip);
  m = __fadd_rn(__fmul_rn(m, h.b1), __fmul_rn(h.omb1, g));
  v = __fadd_rn(__fmul_rn(v, h.b2), __fmul_rn(h.omb2, __fmul_rn(g, g)));
  float d = __fdiv_rn(__fdiv_rn(m, h.bc1),
                      __fadd_rn(__fsqrt_rn(__fdiv_rn(v, h.bc2)), h.eps));
  if (h.decay) d = __fadd_rn(d, __fmul_rn(h.wd, p));
  p = __fsub_rn(p, __fmul_rn(h.lr, d));
}

template <typename P, typename G, typename M>
__global__ void __launch_bounds__(kThreads) adamw_update_kernel(
    P* __restrict__ p, const G* __restrict__ g, M* __restrict__ mu,
    M* __restrict__ nu, long long n, const float* __restrict__ lr,
    const float* __restrict__ clip, const float* __restrict__ bc1,
    const float* __restrict__ bc2, Hyper h) {
  h.lr = *lr, h.clip = *clip, h.bc1 = *bc1, h.bc2 = *bc2;
  const long long groups = n >> 2;
  const int lane = threadIdx.x & 31;
  const long long thread =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long run_groups = 32LL * kGroups;
  const long long stride =
      ((static_cast<long long>(gridDim.x) * kThreads) >> 5) * run_groups;
  for (long long run = (thread >> 5) * run_groups; run < groups;
       run += stride) {
    float vp[kGroups][4], vg[kGroups][4], vm[kGroups][4], vv[kGroups][4];
#pragma unroll
    for (int u = 0; u < kGroups; ++u) {
      const long long at = 4 * (run + 32 * u + lane);
      if (at < 4 * groups) {
        load4(p + at, vp[u]);
        ldg4(g + at, vg[u]);
        load4(mu + at, vm[u]);
        load4(nu + at, vv[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kGroups; ++u) {
      const long long at = 4 * (run + 32 * u + lane);
      if (at < 4 * groups) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          step(vp[u][i], vg[u][i], vm[u][i], vv[u][i], h);
        store4(p + at, vp[u]);
        store4(mu + at, vm[u]);
        store4(nu + at, vv[u]);
      }
    }
  }
  const long long at = 4 * groups + thread;  // the ragged tail
  if (at < n) {
    float vp = to_float(p[at]), vm = to_float(mu[at]), vv = to_float(nu[at]);
    step(vp, to_float(g[at]), vm, vv, h);
    from_float(vp, p + at);
    from_float(vm, mu + at);
    from_float(vv, nu + at);
  }
}

// Sum over a block's threads in a fixed order: a butterfly within each
// warp, then warp 0 over the warps' sums.  Thread 0 returns the total.
__device__ __forceinline__ float block_sum(float x) {
  __shared__ float warp_sums[kThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = x;
  __syncthreads();
  x = threadIdx.x < kThreads / 32 ? warp_sums[threadIdx.x] : 0.0f;
  if (threadIdx.x < 32) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

// 16 bytes of T squared and summed into acc, in element order
__device__ __forceinline__ float add_squares(const uint4& w, float acc,
                                             float) {
  const float v[4] = {__uint_as_float(w.x), __uint_as_float(w.y),
                      __uint_as_float(w.z), __uint_as_float(w.w)};
#pragma unroll
  for (int i = 0; i < 4; ++i) acc = fmaf(v[i], v[i], acc);
  return acc;
}
__device__ __forceinline__ float add_squares(const uint4& w, float acc,
                                             __nv_bfloat16) {
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float a = lo_bf16(words[i]), b = hi_bf16(words[i]);
    acc = fmaf(a, a, acc);
    acc = fmaf(b, b, acc);
  }
  return acc;
}

// partial[b] = Σ x² over the elements block b visits, for each of the
// gridDim.x blocks; x is on 16 bytes.
template <typename T>
__global__ void __launch_bounds__(kThreads) adamw_sqsum_kernel(
    const T* __restrict__ x, long long n, float* __restrict__ partial) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));  // elements a load
  const long long vecs = n / V;
  const long long thread =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long threads = static_cast<long long>(gridDim.x) * kThreads;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  float acc = 0.0f;
  for (long long k = thread; k < vecs; k += threads * kNormLoads) {
    uint4 w[kNormLoads];
#pragma unroll
    for (int j = 0; j < kNormLoads; ++j)
      if (k + j * threads < vecs) w[j] = __ldg(xv + k + j * threads);
#pragma unroll
    for (int j = 0; j < kNormLoads; ++j)
      if (k + j * threads < vecs) acc = add_squares(w[j], acc, T());
  }
  const long long at = vecs * V + thread;  // the ragged tail
  if (at < n) {
    const float v = to_float(x[at]);
    acc = fmaf(v, v, acc);
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) partial[blockIdx.x] = acc;
}

// out[i] = Σ of leaf i's ``blocks`` partials, one block a leaf: thread t
// adds partials t, t + kThreads, ... in order, then block_sum.
__global__ void __launch_bounds__(kThreads) adamw_sqsum_finish_kernel(
    const float* __restrict__ partial, int blocks, float* __restrict__ out) {
  const float* row = partial + static_cast<long long>(blockIdx.x) * blocks;
  float acc = 0.0f;
  for (int j = threadIdx.x; j < blocks; j += kThreads) acc += row[j];
  acc = block_sum(acc);
  if (threadIdx.x == 0) out[blockIdx.x] = acc;
}

// The blocks of ``kernel`` resident on all of device ``dev``'s SMs at
// once: asked of the runtime on the instantiation's first launch on the
// device and kept, so a launch costs the host no attribute or occupancy
// query.
constexpr int kMaxDevices = 64;

template <typename Kernel>
long long wave_of(Kernel kernel, int dev, std::atomic<long long>* waves) {
  long long wave = dev >= 0 && dev < kMaxDevices
                       ? waves[dev].load(std::memory_order_relaxed)
                       : 0;
  if (wave > 0) return wave;
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  wave = static_cast<long long>(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  if (dev >= 0 && dev < kMaxDevices)
    waves[dev].store(wave, std::memory_order_relaxed);
  return wave;
}

// One wave: as many blocks as are resident on all SMs at once, fewer when
// the leaf's runs fill fewer.
template <typename P, typename G, typename M>
int update_as(void* p, const void* g, void* mu, void* nu, long long n,
              const float* lr, const float* clip, const float* bc1,
              const float* bc2, const Hyper& h, cudaStream_t stream) {
  const auto kernel = adamw_update_kernel<P, G, M>;
  static std::atomic<long long> waves[kMaxDevices];
  int dev = 0;
  cudaGetDevice(&dev);
  const long long wave = wave_of(kernel, dev, waves);
  constexpr long long kBlockElems = (kThreads / 32) * 32LL * kGroups * 4;
  const long long want = (n + kBlockElems - 1) / kBlockElems;
  const int grid = static_cast<int>(want < wave ? want : wave);
  kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<P*>(p), static_cast<const G*>(g), static_cast<M*>(mu),
      static_cast<M*>(nu), n, lr, clip, bc1, bc2, h);
  return static_cast<int>(cudaGetLastError());
}

template <typename P, typename G>
int update_moments(int m_dtype, void* p, const void* g, void* mu, void* nu,
                   long long n, const float* lr, const float* clip,
                   const float* bc1, const float* bc2, const Hyper& h,
                   cudaStream_t stream) {
  switch (m_dtype) {
    case 0:
      return update_as<P, G, float>(p, g, mu, nu, n, lr, clip, bc1, bc2, h,
                                    stream);
    case 1:
      return update_as<P, G, __nv_bfloat16>(p, g, mu, nu, n, lr, clip, bc1,
                                             bc2, h, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename P>
int update_grads(int g_dtype, int m_dtype, void* p, const void* g, void* mu,
                 void* nu, long long n, const float* lr, const float* clip,
                 const float* bc1, const float* bc2, const Hyper& h,
                 cudaStream_t stream) {
  switch (g_dtype) {
    case 0:
      return update_moments<P, float>(m_dtype, p, g, mu, nu, n, lr, clip, bc1,
                                      bc2, h, stream);
    case 1:
      return update_moments<P, __nv_bfloat16>(m_dtype, p, g, mu, nu, n, lr,
                                              clip, bc1, bc2, h, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// One leaf's AdamW step, in place.  p, g, mu, nu: n elements each, on 16
// bytes; dtypes 0 fp32, 1 bf16 (mu and nu alike); lr, clip, bc1, bc2:
// one fp32 each on the device; b1, 1 - b1, b2, 1 - b2, eps and the weight
// decay as fp32; decay 1 adds the decay (a leaf of >= 2 dimensions).
extern "C" int adamw_update_launch(void* p, const void* g, void* mu, void* nu,
                                   long long n, const void* lr,
                                   const void* clip, const void* bc1,
                                   const void* bc2, float b1, float omb1,
                                   float b2, float omb2, float eps, float wd,
                                   int decay, int p_dtype, int g_dtype,
                                   int m_dtype, void* stream) {
  if (n <= 0) return 0;
  const Hyper h{0.0f, 0.0f, 0.0f, 0.0f, b1, omb1, b2, omb2, eps, wd, decay};
  const auto* lr_ = static_cast<const float*>(lr);
  const auto* clip_ = static_cast<const float*>(clip);
  const auto* bc1_ = static_cast<const float*>(bc1);
  const auto* bc2_ = static_cast<const float*>(bc2);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (p_dtype) {
    case 0:
      return update_grads<float>(g_dtype, m_dtype, p, g, mu, nu, n, lr_,
                                 clip_, bc1_, bc2_, h, st);
    case 1:
      return update_grads<__nv_bfloat16>(g_dtype, m_dtype, p, g, mu, nu, n,
                                         lr_, clip_, bc1_, bc2_, h, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// partial[0 .. blocks) = the sums of x² over x's n elements (fp32,
// dtype 0, or bf16, dtype 1; on 16 bytes) by each of ``blocks`` blocks.
extern "C" int adamw_sqsum_launch(const void* x, long long n, int dtype,
                                  void* partial, int blocks, void* stream) {
  if (blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(partial);
  switch (dtype) {
    case 0:
      adamw_sqsum_kernel<float><<<blocks, kThreads, 0, st>>>(
          static_cast<const float*>(x), n, out);
      break;
    case 1:
      adamw_sqsum_kernel<__nv_bfloat16><<<blocks, kThreads, 0, st>>>(
          static_cast<const __nv_bfloat16*>(x), n, out);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// out[i] = Σ partial[i * blocks .. (i + 1) * blocks), in a fixed order,
// for i < leaves.
extern "C" int adamw_sqsum_finish_launch(const void* partial, int blocks,
                                         int leaves, void* out,
                                         void* stream) {
  if (leaves <= 0) return 0;
  adamw_sqsum_finish_kernel<<<leaves, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partial), blocks, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
