// Not built: the build compiles csrc/*.cu, and this file sits in
// csrc/designs/.  A measured alternative to csrc/wavelet.cu with the same C
// entries, kept so that its times in PERF.md can be taken again: in a copy
// of the package, put this file in place of csrc/wavelet.cu and run
//   python3 chip_smoke.py --tree <copy> --phases kernels
// in turns with  python3 chip_smoke.py --phases kernels  on one card.
//
// Design: a register tile of 4 blocks a thread (below).
//
// Scale-2 Haar wavelet-packet DWT / IWT on NCHW float32.
//
// Replaces: wavedm_tpu/ops/wavelet_pallas.py:44 _dec_kernel and :60
// _rec_kernel (pallas_call at :75, entries wavelet_dec_pallas:98 and
// wavelet_rec_pallas:121).  Same function: every 4x4 pixel block times the
// orthonormal 16x16 basis haar_packet_basis(2), output channel f*C + c.
//
// Bound on an H100 SXM (3.35 TB/s): memory.  The op reads each input float
// once and writes each output float once and does 256 FMAs per 16 floats
// (4 FLOP/byte), far below the card's ~20 FLOP/byte f32 balance point.  At
// the main path's 2 x 480 x 720 x 3 image: 8.29 MB read + 8.29 MB written
// = 4.95 us.
//
// Each image of either side may sit at any batch stride (in floats) as
// long as its own (C, H, W) or (16C, h, w) block is contiguous: the UNet's
// wavelet_in_unet hook reads the channel slices x[:, :3] and x[:, 3:] of
// one contiguous batch in place and writes each DWT straight into its half
// of the tensor conv_in takes, and the backward of that DWT reads the
// matching channel slices of the gradient.  The pixel side must start
// 16-byte aligned at a batch stride of 4k floats; the coefficient side may
// not (the second half of an output whose planes hold an odd count).
//
// What held the first design (one thread per 4x4 block) back: each thread
// moved its 64 coefficient bytes as 16 scalar 4-byte accesses, one to each
// plane, beside 4 float4 pixel rows -- 20 memory instructions for 128
// bytes -- and the grid of one-shot threads left nothing to overlap one
// block's loads with another's stores but the scheduler.  It read 75-85%
// of the bound at 2 and 8 images.
//
// This design: each thread takes kJ = 4 horizontally adjacent blocks, a
// 4 x 16-pixel strip, and moves 16 bytes at a time on both sides.  The DWT
// loads the strip as 16 float4s (4 rows x 4) and writes the 4 coefficients
// of each of its 16 planes as one float4 (32 memory instructions for 512
// bytes); the IWT is the mirror.  Each coefficient keeps the arithmetic of
// the first design (16 fmaf in the order k = 0..15, the basis folded into
// constants, never TF32), so the outputs are equal to it bit for bit.  A
// strip whose row ends before its 4th block (w % 4 != 0), or whose
// coefficient side is not 16-byte aligned (plane or batch stride), takes
// scalar coefficient accesses in the same launch.  The grid is sized to the
// card (blocks per SM from the occupancy API, asked once per process) and
// walks the strips in a grid-stride loop that issues the next strip's loads
// before the current strip's stores (two register sets).
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

// basis(k, f) = filter_f[p][q] with k = 4p + q: the kron recursion
// filter_f = kron(G[f % 4], G[f / 4]) of 2x2 Haar quads G (entries +-1/2).
__host__ __device__ constexpr float haar_quad_sign(int g, int i, int j) {
  return (((g & 1) & j) ^ (((g >> 1) & 1) & i)) ? -1.f : 1.f;
}

__host__ __device__ constexpr float basis(int k, int f) {
  return 0.25f * haar_quad_sign(f & 3, (k >> 2) >> 1, (k & 3) >> 1) *
         haar_quad_sign(f >> 2, (k >> 2) & 1, (k & 3) & 1);
}

constexpr int kThreads = 128;
constexpr int kJ = 4;   // 4x4 blocks a strip: a float4 of each plane
static_assert(kJ == 4, "a strip's coefficients of one plane are one float4");

// Where the strips lie.  Offsets and strides in floats.
struct Geometry {
  int C, H, W, h, w;
  int strips_per_row;   // ceil(w / kJ)
  int total;            // strips: B * C * h * strips_per_row
  long long px_bstride, co_bstride;
  long long plane;      // h * w
  long long fstride;    // C * plane: from one filter's planes to the next
  bool co_vec;          // coefficient side 16-byte aligned at every strip
};

struct Strip {
  long long px, co;     // offsets of its first pixel and first coefficient
  int n;                // blocks it holds: kJ, or fewer at a row's end
};

__device__ __forceinline__ Strip locate(const Geometry& g, int t) {
  const int s = t % g.strips_per_row;
  int r = t / g.strips_per_row;
  const int i = r % g.h;
  r /= g.h;
  const int c = r % g.C;
  const int b = r / g.C;
  const int j0 = s * kJ;
  Strip st;
  st.px = b * g.px_bstride + ((long long)c * g.H + 4LL * i) * g.W + 4LL * j0;
  st.co = b * g.co_bstride + c * g.plane + (long long)i * g.w + j0;
  st.n = min(kJ, g.w - j0);
  return st;
}

// a[jj][k]: pixel k = 4p + q of block jj (the DWT's input, the IWT's output)
// or coefficient k = f of block jj (the IWT's input, the DWT's output)
using Tile = float[kJ][16];

__device__ __forceinline__ void load_pixels(const float* __restrict__ x,
                                            const Strip& st, int W,
                                            Tile& px) {
#pragma unroll
  for (int p = 0; p < 4; ++p) {
#pragma unroll
    for (int jj = 0; jj < kJ; ++jj) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (jj < st.n)
        v = __ldg(reinterpret_cast<const float4*>(x + st.px + (long long)p * W +
                                                  4 * jj));
      px[jj][4 * p + 0] = v.x;
      px[jj][4 * p + 1] = v.y;
      px[jj][4 * p + 2] = v.z;
      px[jj][4 * p + 3] = v.w;
    }
  }
}

__device__ __forceinline__ void load_coeffs(const float* __restrict__ z,
                                            const Strip& st,
                                            const Geometry& g, Tile& co) {
  const float* src = z + st.co;
  if (g.co_vec && st.n == kJ) {
#pragma unroll
    for (int f = 0; f < 16; ++f) {
      const float4 v =
          __ldg(reinterpret_cast<const float4*>(src + f * g.fstride));
      co[0][f] = v.x;
      co[1][f] = v.y;
      co[2][f] = v.z;
      co[3][f] = v.w;
    }
  } else {
#pragma unroll
    for (int f = 0; f < 16; ++f) {
#pragma unroll
      for (int jj = 0; jj < kJ; ++jj)
        co[jj][f] = jj < st.n ? __ldg(src + f * g.fstride + jj) : 0.f;
    }
  }
}

// coefficient f of a block: sum over k of pixel k * basis(k, f), in order
__device__ __forceinline__ float dwt(const float (&px)[16], int f) {
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < 16; ++k) acc = fmaf(px[k], basis(k, f), acc);
  return acc;
}

// pixel k of a block: sum over f of coefficient f * basis(k, f), in order
__device__ __forceinline__ float iwt(const float (&co)[16], int k) {
  float acc = 0.f;
#pragma unroll
  for (int f = 0; f < 16; ++f) acc = fmaf(co[f], basis(k, f), acc);
  return acc;
}

__device__ __forceinline__ void store_coeffs(float* __restrict__ z,
                                             const Strip& st,
                                             const Geometry& g,
                                             const Tile& px) {
  float* dst = z + st.co;
  if (g.co_vec && st.n == kJ) {
#pragma unroll
    for (int f = 0; f < 16; ++f)
      *reinterpret_cast<float4*>(dst + f * g.fstride) = make_float4(
          dwt(px[0], f), dwt(px[1], f), dwt(px[2], f), dwt(px[3], f));
  } else {
#pragma unroll
    for (int f = 0; f < 16; ++f) {
#pragma unroll
      for (int jj = 0; jj < kJ; ++jj)
        if (jj < st.n) dst[f * g.fstride + jj] = dwt(px[jj], f);
    }
  }
}

__device__ __forceinline__ void store_pixels(float* __restrict__ x,
                                             const Strip& st, int W,
                                             const Tile& co) {
#pragma unroll
  for (int p = 0; p < 4; ++p) {
#pragma unroll
    for (int jj = 0; jj < kJ; ++jj)
      if (jj < st.n)
        *reinterpret_cast<float4*>(x + st.px + (long long)p * W + 4 * jj) =
            make_float4(iwt(co[jj], 4 * p + 0), iwt(co[jj], 4 * p + 1),
                        iwt(co[jj], 4 * p + 2), iwt(co[jj], 4 * p + 3));
  }
}

__device__ __forceinline__ void copy_tile(Tile& dst, const Tile& src) {
#pragma unroll
  for (int jj = 0; jj < kJ; ++jj)
#pragma unroll
    for (int k = 0; k < 16; ++k) dst[jj][k] = src[jj][k];
}

// x (pixels) -> z (coefficients)
__global__ void __launch_bounds__(kThreads)
    wavelet_dec_kernel(const float* __restrict__ x, float* __restrict__ z,
                       Geometry g) {
  int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= g.total) return;
  const int step = gridDim.x * kThreads;
  Strip cur = locate(g, t);
  Tile a, b;
  load_pixels(x, cur, g.W, a);
  for (;;) {
    const int tn = t + step;
    const bool more = tn < g.total;
    Strip nxt{};
    if (more) {
      nxt = locate(g, tn);
      load_pixels(x, nxt, g.W, b);   // in flight during the stores below
    }
    store_coeffs(z, cur, g, a);
    if (!more) break;
    t = tn;
    cur = nxt;
    copy_tile(a, b);
  }
}

// z (coefficients) -> x (pixels)
__global__ void __launch_bounds__(kThreads)
    wavelet_rec_kernel(const float* __restrict__ z, float* __restrict__ x,
                       Geometry g) {
  int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= g.total) return;
  const int step = gridDim.x * kThreads;
  Strip cur = locate(g, t);
  Tile a, b;
  load_coeffs(z, cur, g, a);
  for (;;) {
    const int tn = t + step;
    const bool more = tn < g.total;
    Strip nxt{};
    if (more) {
      nxt = locate(g, tn);
      load_coeffs(z, nxt, g, b);     // in flight during the stores below
    }
    store_pixels(x, cur, g.W, a);
    if (!more) break;
    t = tn;
    cur = nxt;
    copy_tile(a, b);
  }
}

// SMs and resident blocks per SM of each kernel, asked once per process
struct CardPlan {
  int sms = 0, dec_blocks = 0, rec_blocks = 0;
};

const CardPlan& card_plan() {
  static const CardPlan plan = [] {
    CardPlan p;
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&p.sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &p.dec_blocks, wavelet_dec_kernel, kThreads, 0) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &p.rec_blocks, wavelet_rec_kernel, kThreads, 0) != cudaSuccess)
      cudaGetLastError();   // a failed query leaves no error behind
    if (p.sms < 1) p.sms = 132;
    if (p.dec_blocks < 1) p.dec_blocks = 1;
    if (p.rec_blocks < 1) p.rec_blocks = 1;
    return p;
  }();
  return plan;
}

// The geometry of a call, or false for a call the kernels do not take:
// px the pixel side (B, C, H, W), co the coefficient side (B, 16C, H/4,
// W/4), each image at its batch stride (in floats).
bool plan_call(const void* px, const void* co, int B, int C, int H, int W,
               long long px_bstride, long long co_bstride, Geometry* g) {
  const long long image = (long long)C * H * W;
  if (B < 0 || C < 0 || H < 0 || W < 0 || H % 4 || W % 4 ||
      px_bstride % 4 || px_bstride < image || co_bstride < image)
    return false;
  g->C = C;
  g->H = H;
  g->W = W;
  g->h = H / 4;
  g->w = W / 4;
  g->strips_per_row = (g->w + kJ - 1) / kJ;
  const long long total = (long long)B * C * g->h * g->strips_per_row;
  if (total > INT_MAX / 2) return false;   // t + step stays an int
  g->total = (int)total;
  g->px_bstride = px_bstride;
  g->co_bstride = co_bstride;
  g->plane = (long long)g->h * g->w;
  g->fstride = C * g->plane;
  // float4 pixel rows: the pixel side starts 16-byte aligned
  if (g->total && reinterpret_cast<uintptr_t>(px) % 16) return false;
  g->co_vec = reinterpret_cast<uintptr_t>(co) % 16 == 0 &&
              (B < 2 || co_bstride % 4 == 0) && g->w % 4 == 0;
  return true;
}

int grid_for(int total, int blocks_per_sm) {
  const int want = (total + kThreads - 1) / kThreads;
  const int fill = card_plan().sms * blocks_per_sm;
  return want < fill ? want : fill;
}

}  // namespace

// x: (B, C, H, W) float32, image b at x + b * x_bstride -> z: (B, 16*C,
// H/4, W/4), image b at z + b * z_bstride (strides in floats).
extern "C" int wavelet_dec_f32(const void* x, void* z, int B, int C, int H,
                               int W, long long x_bstride,
                               long long z_bstride, void* stream) {
  Geometry g;
  if (!plan_call(x, z, B, C, H, W, x_bstride, z_bstride, &g))
    return (int)cudaErrorInvalidValue;
  if (g.total == 0) return (int)cudaSuccess;
  wavelet_dec_kernel<<<grid_for(g.total, card_plan().dec_blocks), kThreads,
                       0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(z), g);
  return (int)cudaGetLastError();
}

// z: (B, 16*C, H/4, W/4) float32, image b at z + b * z_bstride -> x: (B, C,
// H, W), image b at x + b * x_bstride (strides in floats).
extern "C" int wavelet_rec_f32(const void* z, void* x, int B, int C, int H,
                               int W, long long z_bstride,
                               long long x_bstride, void* stream) {
  Geometry g;
  if (!plan_call(x, z, B, C, H, W, x_bstride, z_bstride, &g))
    return (int)cudaErrorInvalidValue;
  if (g.total == 0) return (int)cudaSuccess;
  wavelet_rec_kernel<<<grid_for(g.total, card_plan().rec_blocks), kThreads,
                       0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(z), static_cast<float*>(x), g);
  return (int)cudaGetLastError();
}
