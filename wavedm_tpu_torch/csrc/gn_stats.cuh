// GroupNorm statistics shared by groupnorm.cu and fused_resblock.cu.
//
// In NCHW one group of one sample is one contiguous segment of (C/G)*H*W
// elements.  segment_mean_rstd streams it once with 16-byte vector loads
// (when every vector stays inside the segment's alignment), accumulates
// sum(x) and sum(x^2) in float32 per thread, reduces with warp shuffles
// and one shared-memory step, and returns mean and 1/sqrt(var + eps) with
// var = max(E[x^2] - E[x]^2, 0): the formula of the TPU kernels it
// replaces, clamped as flax's GroupNorm clamps it (rounding can take a
// near-constant group's variance below -eps, a NaN unclamped).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace wavedm {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// 16-byte vector load: 4 floats or 8 bfloat16s.
__device__ __forceinline__ void load_vec(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// (mean, 1/std) of xs[0:len]; called by every thread of the block (at most
// 1024 threads), which all receive the result.  vec: xs is 16-byte aligned
// and len a multiple of the vector width.
template <typename T>
__device__ float2 segment_mean_rstd(const T* __restrict__ xs, int len,
                                    bool vec, float eps) {
  constexpr int V = 16 / sizeof(T);
  __shared__ float s_part[2][32];
  __shared__ float s_stat[2];

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
    const int nwarps = (blockDim.x + 31) >> 5;
    s1 = lane < nwarps ? s_part[0][lane] : 0.f;
    s2 = lane < nwarps ? s_part[1][lane] : 0.f;
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) {
      const float n = (float)len;
      const float mean = s1 / n;
      const float var = fmaxf(s2 / n - mean * mean, 0.f);
      s_stat[0] = mean;
      s_stat[1] = rsqrtf(var + eps);
    }
  }
  __syncthreads();
  return make_float2(s_stat[0], s_stat[1]);
}

}  // namespace wavedm
