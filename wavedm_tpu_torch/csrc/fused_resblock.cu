// GroupNorm(32, eps) -> swish -> 3x3 SAME conv + bias on NCHW, float32 or
// bfloat16, float32 statistics and float32 accumulation.
//
// Replaces: wavedm_tpu/ops/fused_resblock.py:67 _kernel (entry
// fused_gn_swish_conv:145 -> _forward:175, pallas_call at :198).  Same
// function: per (sample, group) mean and E[x^2] - E[x]^2 in float32, the
// affine folded to y = x*a + b per (sample, channel), swish y*sigmoid(y) in
// float32, y rounded to the compute dtype (= x's dtype here), the 3x3 conv
// over y zero-padded by one pixel (the border is zero AFTER normalize and
// swish, as the TPU kernel's zeroed pad scratch is), float32 accumulation,
// + bias in float32, one rounding to x's dtype.
//
// Bound on an H100 SXM: operations.  The conv is 2*N*H*W*9*Cin*Cout FLOP
// against (Cin + Cout)*N*H*W activations moved: at the flagship's 64x64
// 128->128 site that is 2,304 FLOP per element, far above the card's
// ~295 FLOP/byte bf16 ridge.  The flagship UNet's 44 sites are 58.81 GFLOP
// per 64x64 patch: 5.35 ms per 90-patch forward at the 989 TFLOP/s bf16
// dense peak, 79 ms in float32 at 67 TFLOP/s without tensor cores.
//
// Design (a first kernel: right and simple; wgmma, TMA and a multi-stage
// pipeline come later):
//  - Launch 1 (gn_affine_kernel): one block per (n, g) streams the group's
//    contiguous NCHW segment once (gn_stats.cuh) and writes the folded
//    a[n, c] = rstd*gamma[c], b[n, c] = beta[c] - mean*a[n, c].
//  - Launch 2: implicit GEMM with M = N*H*W output pixels, N = Cout,
//    K = 9*Cin ordered tap-major (k = tap*Cin + ci).  A block computes a
//    128-pixel x 128-channel tile; a 32-deep K chunk lies inside one tap.
//    The A tile is gathered from x: consecutive threads take consecutive
//    pixels of one channel (coalesced along W), apply x*a + b and swish in
//    float32, round to the tile dtype, and write zero where the tap falls
//    outside the image.  The B tile comes from the weights laid out by the
//    wrapper as (9*Cin, Cout_pad) in the compute dtype, 16-byte loads.
//    Global loads of chunk k+1 are issued into registers before the
//    product of chunk k, and normalized when stored to shared memory.
//  - bfloat16: WMMA 16x16x16 bf16 -> f32 fragments, 8 warps of 32x64.
//  - float32: SIMT FMA, 8x8 outputs a thread (no TF32, for parity).
//  Each x element is normalized once per tap and output-channel tile
//  (9 * Cout_pad/128 times); the conv's 9*Cout multiply-adds per element
//  dominate that.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include "gn_stats.cuh"

namespace {

using wavedm::to_f32;

constexpr int kGroups = 32;
constexpr int kStatThreads = 256;
constexpr int kBM = 128;  // output pixels per block
constexpr int kBN = 128;  // output channels per block
constexpr int kBK = 32;   // K chunk (inside one tap: Cin % 32 == 0)
constexpr int kThreads = 256;
constexpr int kARows = kThreads / kBM;      // A rows a thread starts on: 2
constexpr int kAPerThread = kBK / kARows;   // A elements a thread loads: 16

__device__ __forceinline__ float from_f32(float v, float) { return v; }
__device__ __forceinline__ __nv_bfloat16 from_f32(float v, __nv_bfloat16) {
  return __float2bfloat16(v);
}

// ---------------------------------------------------------------- launch 1
template <typename T>
__global__ void __launch_bounds__(kStatThreads)
    gn_affine_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                     const float* __restrict__ beta, float* __restrict__ a_out,
                     float* __restrict__ b_out, int C, int HW, float eps) {
  const int ng = blockIdx.x;
  const int n = ng / kGroups, g = ng % kGroups;
  const int cg = C / kGroups;
  const bool vec = HW % (16 / (int)sizeof(T)) == 0;
  const float2 st = wavedm::segment_mean_rstd(x + (long long)ng * cg * HW,
                                              cg * HW, vec, eps);
  for (int k = threadIdx.x; k < cg; k += blockDim.x) {
    const int c = g * cg + k;
    const float a = st.y * gamma[c];
    a_out[(long long)n * C + c] = a;
    b_out[(long long)n * C + c] = beta[c] - st.x * a;
  }
}

// ---------------------------------------------------------------- launch 2
template <typename T>
struct Smem {
  static constexpr int kLdA = kBM + 16 / sizeof(T);  // +16 bytes a row
  static constexpr int kLdB = kBN + 16 / sizeof(T);
  T a[kBK][kLdA];  // A tile, K-major: a[k][m]
  T b[kBK][kLdB];  // B tile, row-major: b[k][n]
};

// Gathers one K chunk of A (normalized + swished x) and B (weights) per
// thread: load() issues the global loads, store() finishes A and writes
// both tiles to shared memory.
template <typename T>
struct Loader {
  static constexpr int kVB = 16 / sizeof(T);         // B elements a vector
  static constexpr int kBVecRow = kBN / kVB;         // vectors a B row
  static constexpr int kBVecs = kBK * kBVecRow / kThreads;

  const T* x_img;
  const float* a_img;
  const float* b_img;
  const T* wk;
  int HW, H, W, Cin, CoutP, n0, chunks_per_tap;
  int am, ak, ph, pw;
  bool m_ok;
  // in flight
  T areg[kAPerThread];
  uint4 breg[kBVecs];
  bool a_ok;
  int a_ci0;

  __device__ void load(int kt) {
    const int tap = kt / chunks_per_tap;
    const int ci0 = (kt - tap * chunks_per_tap) * kBK;
    const int hs = ph + tap / 3 - 1, ws = pw + tap % 3 - 1;
    a_ok = m_ok && hs >= 0 && hs < H && ws >= 0 && ws < W;
    a_ci0 = ci0;
    if (a_ok) {
      const T* src = x_img + (long long)(ci0 + ak) * HW + hs * W + ws;
#pragma unroll
      for (int i = 0; i < kAPerThread; ++i)
        areg[i] = src[(long long)i * kARows * HW];
    }
    const T* wrow = wk + (long long)kt * kBK * CoutP + n0;
#pragma unroll
    for (int j = 0; j < kBVecs; ++j) {
      const int v = threadIdx.x + j * kThreads;
      const int r = v / kBVecRow, c = (v % kBVecRow) * kVB;
      breg[j] = *reinterpret_cast<const uint4*>(wrow + (long long)r * CoutP + c);
    }
  }

  __device__ void store(Smem<T>& s) {
#pragma unroll
    for (int i = 0; i < kAPerThread; ++i) {
      const int r = ak + i * kARows;
      float y = 0.f;  // SAME padding pads y, not x
      if (a_ok) {
        const int ci = a_ci0 + r;
        y = to_f32(areg[i]) * __ldg(a_img + ci) + __ldg(b_img + ci);
        y = y * (1.f / (1.f + expf(-y)));
      }
      s.a[r][am] = from_f32(y, T());
    }
#pragma unroll
    for (int j = 0; j < kBVecs; ++j) {
      const int v = threadIdx.x + j * kThreads;
      const int r = v / kBVecRow, c = (v % kBVecRow) * kVB;
      *reinterpret_cast<uint4*>(&s.b[r][c]) = breg[j];
    }
  }
};

template <typename T>
__device__ __forceinline__ Loader<T> make_loader(
    const T* x, const float* a_aff, const float* b_aff, const T* wk, int N,
    int Cin, int H, int W, int CoutP, int m0, int n0) {
  Loader<T> ld;
  ld.HW = H * W;
  ld.H = H;
  ld.W = W;
  ld.Cin = Cin;
  ld.CoutP = CoutP;
  ld.n0 = n0;
  ld.chunks_per_tap = Cin / kBK;
  ld.am = threadIdx.x % kBM;
  ld.ak = threadIdx.x / kBM;
  const int m = m0 + ld.am;
  ld.m_ok = m < N * ld.HW;
  const int img = ld.m_ok ? m / ld.HW : 0;
  const int p = ld.m_ok ? m - img * ld.HW : 0;
  ld.ph = p / W;
  ld.pw = p - ld.ph * W;
  ld.x_img = x + (long long)img * Cin * ld.HW;
  ld.a_img = a_aff + (long long)img * Cin;
  ld.b_img = b_aff + (long long)img * Cin;
  ld.wk = wk;
  ld.a_ok = false;
  ld.a_ci0 = 0;
  return ld;
}

// float32: SIMT FMA.  Thread (tm, tn) owns pixels m0 + tm + 16*i and
// channels n0 + tn + 16*j (i, j < 8): shared-memory reads are either
// consecutive (A) or broadcast (B), and stores run along pixels.
__global__ void __launch_bounds__(kThreads)
    conv_f32_kernel(const float* __restrict__ x,
                    const float* __restrict__ a_aff,
                    const float* __restrict__ b_aff,
                    const float* __restrict__ wk,
                    const float* __restrict__ bias, float* __restrict__ out,
                    int N, int Cin, int H, int W, int Cout, int CoutP) {
  __shared__ __align__(16) Smem<float> s;
  const int HW = H * W, M = N * HW;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  Loader<float> ld =
      make_loader(x, a_aff, b_aff, wk, N, Cin, H, W, CoutP, m0, n0);
  const int tm = threadIdx.x % 16, tn = threadIdx.x / 16;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int KT = 9 * (Cin / kBK);
  ld.load(0);
  ld.store(s);
  __syncthreads();
  for (int kt = 0; kt < KT; ++kt) {
    if (kt + 1 < KT) ld.load(kt + 1);
#pragma unroll 4
    for (int k = 0; k < kBK; ++k) {
      float av[8], bv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) av[i] = s.a[k][tm + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) bv[j] = s.b[k][tn + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
    if (kt + 1 < KT) {
      ld.store(s);
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + tm + 16 * i;
    if (m >= M) continue;
    const int img = m / HW, p = m - img * HW;
    float* o = out + (long long)img * Cout * HW + p;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int co = n0 + tn + 16 * j;
      if (co < Cout) o[(long long)co * HW] = acc[i][j] + bias[co];
    }
  }
}

// bfloat16: WMMA bf16 x bf16 -> f32.  Warp (wm, wn) owns a 32x64 sub-tile,
// 2x4 fragments; the epilogue stages each fragment through 1 KB of shared
// memory per warp to store it along pixels.
__global__ void __launch_bounds__(kThreads)
    conv_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                     const float* __restrict__ a_aff,
                     const float* __restrict__ b_aff,
                     const __nv_bfloat16* __restrict__ wk,
                     const float* __restrict__ bias,
                     __nv_bfloat16* __restrict__ out, int N, int Cin, int H,
                     int W, int Cout, int CoutP) {
  using namespace nvcuda;
  using Tiles = Smem<__nv_bfloat16>;
  constexpr int kStageBytes = (kThreads / 32) * 256 * sizeof(float);
  constexpr int kBytes =
      sizeof(Tiles) > kStageBytes ? sizeof(Tiles) : kStageBytes;
  __shared__ __align__(128) unsigned char raw[kBytes];
  Tiles& s = *reinterpret_cast<Tiles*>(raw);

  const int HW = H * W, M = N * HW;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  Loader<__nv_bfloat16> ld =
      make_loader(x, a_aff, b_aff, wk, N, Cin, H, W, CoutP, m0, n0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp % 4, wn = warp / 4;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int KT = 9 * (Cin / kBK);
  ld.load(0);
  ld.store(s);
  __syncthreads();
  for (int kt = 0; kt < KT; ++kt) {
    if (kt + 1 < KT) ld.load(kt + 1);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major>
          fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          fb[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], &s.a[kk][wm * 32 + i * 16], Tiles::kLdA);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(fb[j], &s.b[kk][wn * 64 + j * 16], Tiles::kLdB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
    if (kt + 1 < KT) {
      ld.store(s);
      __syncthreads();
    }
  }

  // the tiles are dead: reuse their memory as per-warp staging
  float* stage = reinterpret_cast<float*>(raw) + warp * 256;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_col_major);
      __syncwarp();
      const int mb = m0 + wm * 32 + i * 16, nb = n0 + wn * 64 + j * 16;
      for (int e = lane; e < 256; e += 32) {
        const int m = mb + (e & 15), co = nb + (e >> 4);
        if (m < M && co < Cout) {
          const int img = m / HW, p = m - img * HW;
          out[((long long)img * Cout + co) * HW + p] =
              __float2bfloat16(stage[e] + bias[co]);
        }
      }
      __syncwarp();
    }
  }
}

template <typename T>
void conv_launch(const T* x, const float* a, const float* b, const T* wk,
                 const float* bias, T* out, int N, int Cin, int H, int W,
                 int Cout, int CoutP, dim3 grid, cudaStream_t s);

template <>
void conv_launch<float>(const float* x, const float* a, const float* b,
                        const float* wk, const float* bias, float* out, int N,
                        int Cin, int H, int W, int Cout, int CoutP, dim3 grid,
                        cudaStream_t s) {
  conv_f32_kernel<<<grid, kThreads, 0, s>>>(x, a, b, wk, bias, out, N, Cin, H,
                                            W, Cout, CoutP);
}

template <>
void conv_launch<__nv_bfloat16>(const __nv_bfloat16* x, const float* a,
                                const float* b, const __nv_bfloat16* wk,
                                const float* bias, __nv_bfloat16* out, int N,
                                int Cin, int H, int W, int Cout, int CoutP,
                                dim3 grid, cudaStream_t s) {
  conv_bf16_kernel<<<grid, kThreads, 0, s>>>(x, a, b, wk, bias, out, N, Cin,
                                             H, W, Cout, CoutP);
}

template <typename T>
int launch(const void* x, const void* gamma, const void* beta, const void* wk,
           const void* bias, void* ab, void* out, int N, int Cin, int H,
           int W, int Cout, int CoutP, float eps, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cin % kBK || Cout <= 0 ||
      CoutP < Cout || CoutP % kBN || (long long)N * H * W >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* a = static_cast<float*>(ab);
  float* b = a + (long long)N * Cin;
  const T* xp = static_cast<const T*>(x);
  gn_affine_kernel<T><<<N * kGroups, kStatThreads, 0, s>>>(
      xp, static_cast<const float*>(gamma), static_cast<const float*>(beta),
      a, b, Cin, H * W, eps);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long M = (long long)N * H * W;
  const dim3 grid((unsigned)((M + kBM - 1) / kBM), (unsigned)(CoutP / kBN));
  conv_launch<T>(xp, a, b, static_cast<const T*>(wk),
                 static_cast<const float*>(bias), static_cast<T*>(out), N, Cin,
                 H, W, Cout, CoutP, grid, s);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (N, Cin, H, W) contiguous; gamma, beta: (Cin,) float32; wk: (9*Cin,
// CoutP) in x's dtype, row tap*Cin + ci, zero past Cout; bias: (Cout,)
// float32; ab: 2*N*Cin float32 scratch; out: (N, Cout, H, W) in x's dtype.
extern "C" int fused_gn_swish_conv_f32(const void* x, const void* gamma,
                                       const void* beta, const void* wk,
                                       const void* bias, void* ab, void* out,
                                       int N, int Cin, int H, int W, int Cout,
                                       int CoutP, float eps, void* stream) {
  return launch<float>(x, gamma, beta, wk, bias, ab, out, N, Cin, H, W, Cout,
                       CoutP, eps, stream);
}

extern "C" int fused_gn_swish_conv_bf16(const void* x, const void* gamma,
                                        const void* beta, const void* wk,
                                        const void* bias, void* ab, void* out,
                                        int N, int Cin, int H, int W, int Cout,
                                        int CoutP, float eps, void* stream) {
  return launch<__nv_bfloat16>(x, gamma, beta, wk, bias, ab, out, N, Cin, H,
                               W, Cout, CoutP, eps, stream);
}
