// GroupNorm(+swish) on NCHW, float32 or bfloat16, float32 statistics.
//
// Replaces: wavedm_tpu/ops/groupnorm_pallas.py:27 _kernel (entry
// fused_group_norm:71, pallas_call at :91).  Same function: per (sample,
// group) mean and E[x^2] - E[x]^2 in float32, eps inside the rsqrt, the
// affine folded to y = x*a + b per channel, optional swish y*sigmoid(y),
// output in the input dtype.  The formula is kept (not Welford) so the
// kernel computes what the TPU kernel computes.
//
// Bound on an H100 SXM (3.35 TB/s): memory.  The op does ~10 FLOP per
// element against 4 (bf16) or 8 (f32) bytes moved.  Counting one read of x
// and one write of y, the flagship UNet's 51 norm sites at N = 90 patches
// (two 720x480 images) hold 1.30e9 elements per forward: 10.4 GB moved in
// f32, 3.10 ms per forward at the bound (5.2 GB, 1.55 ms in bf16).
//
// Design against that bound: in NCHW one group of one sample is one
// contiguous segment of (C/G)*H*W elements (at most 12 x 4096 = 49,152 at
// the flagship's 64x64x384 site), so one block owns one (n, g) segment:
// 1,440 blocks at N = 45.  Pass 1 streams the segment with 16-byte vector
// loads and accumulates sum(x) and sum(x^2) in float32 per thread, then
// reduces with warp shuffles and one shared-memory step.  The block derives
// the group's mean and 1/std and each channel's folded (a, b) into shared
// memory.  Pass 2 re-reads the segment -- at most 192 KB, so it comes from
// the 50 MB L2, not from device memory -- and stores y = x*a + b (+ swish)
// with 16-byte vector stores.  Device memory sees one read and one write.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_elem(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_elem(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// 16-byte vector load / store: 4 floats or 8 bfloat16s.
__device__ __forceinline__ void load_vec(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}
__device__ __forceinline__ void store_vec(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&v)[8]) {
  const uint4 t = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* p,
                                          const float (&v)[8]) {
  uint4 t;
  __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&t);
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] = __float2bfloat16(v[i]);
  *reinterpret_cast<uint4*>(p) = t;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <bool SWISH>
__device__ __forceinline__ float finish(float v, float a, float b) {
  float y = v * a + b;
  if (SWISH) y = y * (1.f / (1.f + expf(-y)));
  return y;
}

// grid: one block per (n, g); dynamic shared memory: 2 * (C/G) floats.
template <typename T, bool SWISH>
__global__ void group_norm_kernel(const T* __restrict__ x,
                                  const float* __restrict__ gamma,
                                  const float* __restrict__ beta,
                                  T* __restrict__ y, int C, int HW, int G,
                                  float eps) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ float s_ab[];  // a[0:cg], b[cg:2cg]
  __shared__ float s_part[2][32];
  __shared__ float s_stat[2];

  const int ng = blockIdx.x;
  const int g = ng % G;
  const int cg = C / G;
  const int len = cg * HW;
  const T* xs = x + (long long)ng * len;
  T* ys = y + (long long)ng * len;
  // every vector stays inside one channel and the segment start is aligned
  const bool vec = (HW % V) == 0;

  float s1 = 0.f, s2 = 0.f;
  if (vec) {
    for (int e = threadIdx.x * V; e < len; e += blockDim.x * V) {
      float v[V];
      load_vec(xs + e, v);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        s1 += v[i];
        s2 += v[i] * v[i];
      }
    }
  } else {
    for (int e = threadIdx.x; e < len; e += blockDim.x) {
      const float v = to_f32(xs[e]);
      s1 += v;
      s2 += v * v;
    }
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  if (lane == 0) {
    s_part[0][warp] = s1;
    s_part[1][warp] = s2;
  }
  __syncthreads();
  if (warp == 0) {
    const int nwarps = blockDim.x >> 5;
    s1 = lane < nwarps ? s_part[0][lane] : 0.f;
    s2 = lane < nwarps ? s_part[1][lane] : 0.f;
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) {
      const float n = (float)len;
      const float mean = s1 / n;
      const float var = s2 / n - mean * mean;
      s_stat[0] = mean;
      s_stat[1] = rsqrtf(var + eps);
    }
  }
  __syncthreads();
  const float mean = s_stat[0], inv = s_stat[1];
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
      for (int i = 0; i < V; ++i) v[i] = finish<SWISH>(v[i], a, b);
      store_vec(ys + e, v);
    }
  } else {
    for (int e = threadIdx.x; e < len; e += blockDim.x) {
      const int k = e / HW;
      store_elem(ys + e, finish<SWISH>(to_f32(xs[e]), s_ab[k], s_ab[cg + k]));
    }
  }
}

template <typename T>
int launch(const void* x, const void* gamma, const void* beta, void* y, int N,
           int C, int HW, int G, float eps, int swish, void* stream) {
  if (N < 0 || C <= 0 || HW < 0 || G <= 0 || C % G)
    return (int)cudaErrorInvalidValue;
  if ((long long)N * G == 0 || HW == 0) return (int)cudaSuccess;
  const int cg = C / G;
  const size_t smem = 2 * cg * sizeof(float);
  const dim3 grid((unsigned)(N * G));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  const float* gp = static_cast<const float*>(gamma);
  const float* bp = static_cast<const float*>(beta);
  if (swish)
    group_norm_kernel<T, true><<<grid, kThreads, smem, s>>>(xp, gp, bp, yp, C,
                                                            HW, G, eps);
  else
    group_norm_kernel<T, false><<<grid, kThreads, smem, s>>>(xp, gp, bp, yp, C,
                                                             HW, G, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y: (N, C, H, W) contiguous, HW = H*W; gamma, beta: (C,) float32.
extern "C" int group_norm_f32(const void* x, const void* gamma,
                              const void* beta, void* y, int N, int C, int HW,
                              int G, float eps, int swish, void* stream) {
  return launch<float>(x, gamma, beta, y, N, C, HW, G, eps, swish, stream);
}

extern "C" int group_norm_bf16(const void* x, const void* gamma,
                               const void* beta, void* y, int N, int C, int HW,
                               int G, float eps, int swish, void* stream) {
  return launch<__nv_bfloat16>(x, gamma, beta, y, N, C, HW, G, eps, swish,
                               stream);
}
