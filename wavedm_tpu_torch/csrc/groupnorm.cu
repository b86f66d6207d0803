// GroupNorm(+swish) on NCHW, float32 or bfloat16, float32 statistics.
//
// Replaces: wavedm_tpu/ops/groupnorm_pallas.py:27 _kernel (entry
// fused_group_norm:71, pallas_call at :91).  Same function: per (sample,
// group) mean and E[x^2] - E[x]^2 in float32, eps inside the rsqrt, the
// affine folded to y = x*a + b per channel, optional swish y*sigmoid(y),
// output in the input dtype.  The formula is kept (not Welford) so the
// kernel computes what the TPU kernel computes.  Its rounding can take a
// near-constant group's variance below 0 (below -eps: a NaN), so it is
// clamped at 0 first, as flax's GroupNorm clamps it; where it is not
// negative nothing changes.
//
// The same kernels also serve the UNet's default route (``Normalize`` with
// fused=False, under no autograd), whose numerics are flax's
// nn.GroupNorm(dtype=bfloat16) followed by a swish on its bfloat16 output:
// with kRound set, y = x*a + b is rounded to the activation dtype, and the
// swish runs in float32 on that rounded value and is rounded again, as the
// eager chain F.silu(F.group_norm(x.float(), ...).to(bf16)) does.  The
// statistics are the same.  In float32 the rounding is the identity and
// kRound changes nothing.
//
// Bound on an H100 SXM (3.35 TB/s): memory.  The op does ~10 FLOP per
// element against 4 (bf16) or 8 (f32) bytes moved.  Counting one read of x
// and one write of y, the flagship UNet's 51 norm sites at N = 90 patches
// (two 720x480 images) hold 1.30e9 elements per forward: 10.4 GB moved in
// f32, 3.10 ms per forward at the bound (5.2 GB, 1.55 ms in bf16).
//
// Design against that bound: each activation leaves device memory once
// and is written once.  In NCHW one group of one sample is one contiguous
// segment of (C/G)*H*W elements (1,024 to 49,152 at the flagship's sites),
// and the segment stays in shared memory between its statistics and the
// apply.  ops/groupnorm_cuda.py's group_norm_plan sizes the launch (a
// block holds at most 96 KB, so two blocks share an SM):
//  - a segment larger than that is split over a thread-block cluster of
//    k = 2, 4 or 8 blocks, one slice each (slices start on 16-byte
//    boundaries); each block reduces its slice's (sum x, sum x^2), the
//    blocks exchange the partials through distributed shared memory and
//    add them in rank order, so every block derives the same mean and
//    1/std;
//  - a segment under 24 KB takes a block of 128 threads, and one of 8 KB
//    or less shares it with the next (the two are one contiguous range),
//    two warps to each.
// A slice arrives by one TMA bulk copy (cp.async.bulk, completing on an
// mbarrier), so the whole slice is in flight at once and no thread spends
// registers on it; the apply reads it back from shared memory and stores
// 16-byte vectors.  Swish is y / (1 + 2^(-y log2 e)) with the MUFU
// exponent and reciprocal (__expf, __fdividef): relative error ~1e-6,
// far inside the 2e-5 float32 tolerance, and the bf16 path needs the
// instruction rate.  A shape whose HW is not a multiple of the 16-byte
// vector (or an unaligned tensor) takes the same path element by element.
//
// A segment larger than 8 slices of the largest dynamic shared memory a
// block has (~1.8 MB) does not fit on chip: it takes the two-pass stream
// kernel (statistics, then the apply re-reading x from device memory or
// L2), with compensated sums.  The flagship never reaches it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gn_stats.cuh"

namespace {

using wavedm::load_vec;
using wavedm::to_f32;
using wavedm::warp_sum;

// the stream kernel's block, and the largest the on-chip kernel takes
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPack = 2;  // segments an on-chip block holds
constexpr int kMaxCluster = 8;
constexpr int kMaxDynSmem = 232448 - 1024;  // H100 block limit, less statics

__device__ __forceinline__ void store_elem(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_elem(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// 16-byte vector store: 4 floats or 8 bfloat16s.
__device__ __forceinline__ void store_vec(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* p,
                                          const float (&v)[8]) {
  uint4 t;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&t);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = t;
}

// The epilogue, a bit set (the C entries' `mode`): kSwish follows the
// affine with a swish; kRound rounds the affine's output to the activation
// dtype first (the default route's rounding, above).
constexpr int kSwish = 1;
constexpr int kRound = 2;

__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

// y = v * a + b, then swish with the MUFU exponent and reciprocal.  1 + e
// is +inf for y < -88, and y * rcp(inf) = -0, the limit.
template <typename T, int MODE>
__device__ __forceinline__ float finish(float v, float a, float b) {
  float y = v * a + b;
  if (MODE & kRound) y = round_to(y, static_cast<const T*>(nullptr));
  return (MODE & kSwish) ? __fdividef(y, 1.f + __expf(-y)) : y;
}

// n / d for 0 <= n < 2^31, 1 <= d < 2^31 by a multiply-high (Granlund and
// Montgomery): the host finds m and s once per launch.
struct FastDiv {
  uint32_t m, s;
  __device__ __forceinline__ int div(int n) const {
    return (int)((__umulhi((uint32_t)n, m) + (uint32_t)n) >> s);
  }
};

FastDiv make_fastdiv(int d) {
  uint32_t s = 0;
  while ((1ull << s) < (uint64_t)d) ++s;
  const uint64_t m = ((1ull << 32) * ((1ull << s) - (uint64_t)d)) / d + 1;
  return FastDiv{(uint32_t)m, s};
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
// Arrive on the barrier, expecting `bytes` to land before its phase ends.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
// One bulk (TMA) copy of `bytes` contiguous bytes (a multiple of 16, both
// ends 16-byte aligned) into this block's shared memory.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}
// Cluster barrier halves: arrive releases this thread's shared-memory
// writes, wait acquires the other blocks'.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// The float2 at this block's `p`, read from cluster block `rank`.
__device__ __forceinline__ float2 ld_cluster(const float2* p, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_u32(p)), "r"(rank));
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(remote)
               : "memory");
  return v;
}

struct OnChip {
  int segs;      // N * G
  int L;         // segment length, (C/G) * HW
  int G, cg;
  int slice;     // elements a block (cluster > 1) or a segment (packed) holds
  int cluster;   // blocks a segment (1, 2, 4, 8)
  int m;         // segments a block (1, 2); cluster > 1 -> 1
  FastDiv hw;    // division by HW: the channel of an element
  float eps;
  bool vec;      // 16-byte vectors, bulk copies
};

// grid: ceil(segs / m) * cluster blocks of 128 or 256 threads; dynamic
// shared memory: m * slice elements.  Block b holds slice (b % cluster) of
// segments (b / cluster) * m ... + m - 1, its team t (a 1/m share of its
// warps) segment t.
template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
    group_norm_onchip_kernel(const T* __restrict__ x,
                             const float* __restrict__ gamma,
                             const float* __restrict__ beta,
                             T* __restrict__ y, const OnChip p) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t s_bar[kMaxPack];
  __shared__ float2 s_warp[kWarps];
  __shared__ float2 s_cta, s_stat;

  const int k = p.cluster;
  const int rank = blockIdx.x % k;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tw = (blockDim.x >> 5) / p.m;      // warps a team
  const int team = warp / tw;
  const int tt = threadIdx.x - team * tw * 32;  // thread in team
  const int tn = tw * 32;                       // threads a team
  const int seg = (blockIdx.x / k) * p.m + team;
  const int start = rank * p.slice;             // in the segment
  const int len = seg < p.segs ? max(0, min(p.L - start, p.slice)) : 0;
  T* sb = reinterpret_cast<T*>(smem_raw) + (long long)team * p.slice;
  const long long off = (long long)seg * p.L + start;

  // ---- the slice into shared memory, once
  if (p.vec) {
    if (threadIdx.x == 0) {
      for (int t = 0; t < p.m; ++t) mbar_init(smem_u32(&s_bar[t]), 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    const uint32_t bar = smem_u32(&s_bar[team]);
    if (len > 0) {
      if (tt == 0) {
        const uint32_t bytes = (uint32_t)len * sizeof(T);
        mbar_expect_tx(bar, bytes);
        bulk_copy(smem_u32(sb), x + off, bytes, bar);
      }
      mbar_wait(bar, 0);
    }
  } else {
    for (int e = tt; e < len; e += tn) sb[e] = x[off + e];
    __syncthreads();
  }

  // ---- (sum x, sum x^2) of the team's slice, float32
  float s1 = 0.f, s2 = 0.f;
  if (p.vec) {
    for (int e = tt * V; e < len; e += tn * V) {
      float v[V];
      load_vec(sb + e, v);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        s1 += v[i];
        s2 += v[i] * v[i];
      }
    }
  } else {
    for (int e = tt; e < len; e += tn) {
      const float v = to_f32(sb[e]);
      s1 += v;
      s2 += v * v;
    }
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  if (tw > 1) {   // the team's warps, in order
    if (lane == 0) s_warp[warp] = make_float2(s1, s2);
    __syncthreads();
    s1 = s2 = 0.f;
    for (int w = team * tw; w < (team + 1) * tw; ++w) {
      s1 += s_warp[w].x;
      s2 += s_warp[w].y;
    }
  }
  if (k > 1) {    // the cluster's slices, in rank order in every block
    if (threadIdx.x == 0) s_cta = make_float2(s1, s2);
    cluster_arrive();
    cluster_wait();
    if (threadIdx.x == 0) {
      float2 t = make_float2(0.f, 0.f);
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) {
        if (r < k) {
          const float2 v = ld_cluster(&s_cta, r);
          t.x += v.x;
          t.y += v.y;
        }
      }
      s_stat = t;
    }
    __syncwarp();
    cluster_arrive();   // done reading the others' s_cta; wait at exit
    __syncthreads();
    s1 = s_stat.x;
    s2 = s_stat.y;
  }
  const float n = (float)p.L;
  const float mean = s1 / n;
  const float inv = rsqrtf(fmaxf(s2 / n - mean * mean, 0.f) + p.eps);

  // ---- y = x * a + b (+ rounding, + swish) from shared memory, 16-byte
  // stores
  const int g = seg % p.G;
  const float* gam = gamma + g * p.cg;
  const float* bet = beta + g * p.cg;
  T* ys = y + off;
  if (p.vec) {
    for (int e = tt * V; e < len; e += tn * V) {
      const int c = p.hw.div(start + e);
      const float a = inv * __ldg(gam + c);
      const float b = __ldg(bet + c) - mean * a;
      float v[V];
      load_vec(sb + e, v);
#pragma unroll
      for (int i = 0; i < V; ++i) v[i] = finish<T, MODE>(v[i], a, b);
      store_vec(ys + e, v);
    }
  } else {
    for (int e = tt; e < len; e += tn) {
      const int c = p.hw.div(start + e);
      const float a = inv * __ldg(gam + c);
      store_elem(ys + e, finish<T, MODE>(to_f32(sb[e]), a,
                                            __ldg(bet + c) - mean * a));
    }
  }
  if (k > 1) cluster_wait();   // no block leaves while another reads it
}

// Kahan-compensated float32 running sum.  A stream-kernel thread adds
// thousands of elements (a segment of a million, 256 threads): a plain
// chain that long drifts by ~1e-6 of the mean, which shows in a bfloat16
// output near zero.
struct KahanSum {
  float s = 0.f, c = 0.f;
  __device__ __forceinline__ void add(float v) {
    const float t = s + (v - c);
    c = (t - s) - (v - c);
    s = t;
  }
};

// (mean, 1/std) of xs[0:len] for every thread of the block: compensated
// per-thread sums of x and x^2, then warp shuffles and one shared-memory
// step, var = max(E[x^2] - E[x]^2, 0).
template <typename T>
__device__ float2 stream_mean_rstd(const T* __restrict__ xs, int len,
                                   bool vec, float eps) {
  constexpr int V = 16 / sizeof(T);
  __shared__ float2 s_part[kWarps];
  __shared__ float2 s_stat;
  KahanSum s1, s2;
  if (vec) {
    for (int e = threadIdx.x * V; e < len; e += kThreads * V) {
      float v[V];
      load_vec(xs + e, v);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        s1.add(v[i]);
        s2.add(v[i] * v[i]);
      }
    }
  } else {
    for (int e = threadIdx.x; e < len; e += kThreads) {
      const float v = to_f32(xs[e]);
      s1.add(v);
      s2.add(v * v);
    }
  }
  const float t1 = warp_sum(s1.s), t2 = warp_sum(s2.s);
  if ((threadIdx.x & 31) == 0) s_part[threadIdx.x >> 5] = make_float2(t1, t2);
  __syncthreads();
  if (threadIdx.x == 0) {
    float a = 0.f, b = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      a += s_part[w].x;
      b += s_part[w].y;
    }
    const float mean = a / (float)len;
    s_stat = make_float2(
        mean, rsqrtf(fmaxf(b / (float)len - mean * mean, 0.f) + eps));
  }
  __syncthreads();
  return s_stat;
}

// The two-pass kernel, for segments too large to hold on chip, with
// compensated statistics.  grid: one block per (n, g); dynamic shared
// memory: 2 * (C/G) floats.
template <typename T, int MODE>
__global__ void group_norm_stream_kernel(const T* __restrict__ x,
                                         const float* __restrict__ gamma,
                                         const float* __restrict__ beta,
                                         T* __restrict__ y, int C, int HW,
                                         int G, float eps, bool vec) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ float s_ab[];  // a[0:cg], b[cg:2cg]

  const int ng = blockIdx.x;
  const int g = ng % G;
  const int cg = C / G;
  const int len = cg * HW;
  const T* xs = x + (long long)ng * len;
  T* ys = y + (long long)ng * len;

  const float2 stat = stream_mean_rstd(xs, len, vec, eps);
  const float mean = stat.x, inv = stat.y;
  for (int k = threadIdx.x; k < cg; k += blockDim.x) {
    const float a = inv * gamma[g * cg + k];
    s_ab[k] = a;
    s_ab[cg + k] = beta[g * cg + k] - mean * a;
  }
  __syncthreads();

  if (vec) {
    for (int e = threadIdx.x * V; e < len; e += blockDim.x * V) {
      const int k = e / HW;
      const float a = s_ab[k], b = s_ab[cg + k];
      float v[V];
      load_vec(xs + e, v);
#pragma unroll
      for (int i = 0; i < V; ++i) v[i] = finish<T, MODE>(v[i], a, b);
      store_vec(ys + e, v);
    }
  } else {
    for (int e = threadIdx.x; e < len; e += blockDim.x) {
      const int k = e / HW;
      store_elem(ys + e,
                 finish<T, MODE>(to_f32(xs[e]), s_ab[k], s_ab[cg + k]));
    }
  }
}

bool is_pow2_upto8(int v) { return v == 1 || v == 2 || v == 4 || v == 8; }

template <typename T, int MODE>
cudaError_t launch_onchip(const T* x, const float* g, const float* b, T* y,
                          const OnChip& p, int grid, int threads, int smem,
                          cudaStream_t s) {
  auto kernel = group_norm_onchip_kernel<T, MODE>;
  static bool configured[64] = {};   // per device: attributes set once
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (!configured[device]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxDynSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    configured[device] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.cluster > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, x, g, b, y, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, int MODE>
cudaError_t launch_mode(const T* x, const float* g, const float* b, T* y,
                        int C, int HW, int G, float eps, bool stream_vec,
                        const OnChip& p, int grid, int threads, int smem,
                        cudaStream_t s) {
  if (p.cluster == 0) {
    group_norm_stream_kernel<T, MODE><<<grid, kThreads, smem, s>>>(
        x, g, b, y, C, HW, G, eps, stream_vec);
    return cudaGetLastError();
  }
  return launch_onchip<T, MODE>(x, g, b, y, p, grid, threads, smem, s);
}

// cluster == 0: the stream kernel; else the on-chip kernel with `cluster`
// blocks a segment, `m` segments a block, `slice` elements a slice and
// `threads` a block (group_norm_plan in ops/groupnorm_cuda.py).  mode: the
// epilogue's bits (kSwish, kRound).
template <typename T>
int launch(const void* x, const void* gamma, const void* beta, void* y, int N,
           int C, int HW, int G, float eps, int mode, int cluster, int m,
           int slice, int threads, void* stream) {
  constexpr int V = 16 / sizeof(T);
  if (N < 0 || C <= 0 || HW < 0 || G <= 0 || C % G || mode < 0 ||
      mode > (kSwish | kRound))
    return (int)cudaErrorInvalidValue;
  if ((long long)N * G == 0 || HW == 0) return (int)cudaSuccess;
  const int cg = C / G;
  const long long L = (long long)cg * HW;
  if (L >= (1LL << 31) || (long long)N * G >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  const float* gp = static_cast<const float*>(gamma);
  const float* bp = static_cast<const float*>(beta);
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) %
       16) == 0;

  OnChip p = {};
  long long smem;
  int grid;
  if (cluster == 0) {
    smem = 2 * cg * sizeof(float);
    if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
    grid = N * G;
  } else {
    p.segs = N * G;
    p.L = (int)L;
    p.G = G;
    p.cg = cg;
    p.slice = slice;
    p.cluster = cluster;
    p.m = m;
    p.hw = make_fastdiv(HW);
    p.eps = eps;
    p.vec = aligned && HW % V == 0 && slice % V == 0;
    smem = (long long)m * slice * sizeof(T);
    if (!is_pow2_upto8(cluster) || m < 1 || m > kMaxPack ||
        (cluster > 1 && m > 1) || slice <= 0 ||
        (threads != 128 && threads != 256) ||
        (long long)slice * cluster < L || (cluster == 1 && slice != L) ||
        smem > kMaxDynSmem)
      return (int)cudaErrorInvalidValue;
    grid = (p.segs + m - 1) / m * cluster;
  }
  const bool stream_vec = aligned && HW % V == 0;
  cudaError_t err;
  switch (mode) {
    case 0:
      err = launch_mode<T, 0>(xp, gp, bp, yp, C, HW, G, eps, stream_vec, p,
                              grid, threads, (int)smem, s);
      break;
    case kSwish:
      err = launch_mode<T, kSwish>(xp, gp, bp, yp, C, HW, G, eps, stream_vec,
                                   p, grid, threads, (int)smem, s);
      break;
    case kRound:
      err = launch_mode<T, kRound>(xp, gp, bp, yp, C, HW, G, eps, stream_vec,
                                   p, grid, threads, (int)smem, s);
      break;
    default:
      err = launch_mode<T, kSwish | kRound>(xp, gp, bp, yp, C, HW, G, eps,
                                            stream_vec, p, grid, threads,
                                            (int)smem, s);
  }
  return (int)err;
}

}  // namespace

// x, y: (N, C, H, W) contiguous, HW = H*W; gamma, beta: (C,) float32;
// mode: 0 GroupNorm, 1 + swish, 2 and 3 the same rounded as the default
// route; cluster, m, slice, threads: the launch plan (cluster 0: the stream
// kernel).
extern "C" int group_norm_f32(const void* x, const void* gamma,
                              const void* beta, void* y, int N, int C, int HW,
                              int G, float eps, int mode, int cluster, int m,
                              int slice, int threads, void* stream) {
  return launch<float>(x, gamma, beta, y, N, C, HW, G, eps, mode, cluster, m,
                       slice, threads, stream);
}

extern "C" int group_norm_bf16(const void* x, const void* gamma,
                               const void* beta, void* y, int N, int C, int HW,
                               int G, float eps, int mode, int cluster, int m,
                               int slice, int threads, void* stream) {
  return launch<__nv_bfloat16>(x, gamma, beta, y, N, C, HW, G, eps, mode,
                               cluster, m, slice, threads, stream);
}
