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
// Each image of either side may sit at any batch stride (in floats, a
// multiple of 4) as long as its own (C, H, W) or (16C, h, w) block is
// contiguous: the UNet's wavelet_in_unet hook reads the channel slices
// x[:, :3] and x[:, 3:] of one contiguous batch in place and writes each
// DWT straight into its half of the tensor conv_in takes, and the
// backward of that DWT reads the matching channel slices of the gradient.
//
// Design against that bound: one thread per (b, c, i, j) block.  It reads
// its block as four 16-byte float4 rows (neighbouring threads read
// neighbouring 16-byte words, so a warp reads 512 contiguous bytes per row)
// and writes its 16 coefficients to 16 channel planes, where neighbouring
// threads write neighbouring floats (coalesced along j).  The basis entries
// are +-1/4, folded into the unrolled code as constants; the arithmetic is
// f32 FMA (never TF32), so x*(+-1/4) is exact and only the 15 additions per
// output round -- the round trip stays at float32 round-off.  No padding:
// the grid covers exactly B*C*(H/4)*(W/4) threads and masks its tail.
#include <cuda_runtime.h>

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

constexpr int kThreads = 256;

__global__ void wavelet_dec_kernel(const float* __restrict__ x,
                                   float* __restrict__ z, int C, int H, int W,
                                   long long x_bstride, long long z_bstride,
                                   long long total) {
  const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int h = H >> 2, w = W >> 2;
  const int j = (int)(idx % w);
  long long r = idx / w;
  const int i = (int)(r % h);
  r /= h;
  const int c = (int)(r % C);
  const long long b = r / C;

  const float* src = x + b * x_bstride + ((long long)c * H + 4LL * i) * W +
                     4LL * j;
  float px[16];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const float4 v = *reinterpret_cast<const float4*>(src + (long long)p * W);
    px[4 * p + 0] = v.x;
    px[4 * p + 1] = v.y;
    px[4 * p + 2] = v.z;
    px[4 * p + 3] = v.w;
  }
  const long long plane = (long long)h * w;
  float* dst = z + b * z_bstride + c * plane + (long long)i * w + j;
#pragma unroll
  for (int f = 0; f < 16; ++f) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < 16; ++k) acc = fmaf(px[k], basis(k, f), acc);
    dst[(long long)f * C * plane] = acc;
  }
}

__global__ void wavelet_rec_kernel(const float* __restrict__ z,
                                   float* __restrict__ x, int C, int H, int W,
                                   long long z_bstride, long long x_bstride,
                                   long long total) {
  const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int h = H >> 2, w = W >> 2;
  const int j = (int)(idx % w);
  long long r = idx / w;
  const int i = (int)(r % h);
  r /= h;
  const int c = (int)(r % C);
  const long long b = r / C;

  const long long plane = (long long)h * w;
  const float* src = z + b * z_bstride + c * plane + (long long)i * w + j;
  float co[16];
#pragma unroll
  for (int f = 0; f < 16; ++f) co[f] = src[(long long)f * C * plane];

  float* dst = x + b * x_bstride + ((long long)c * H + 4LL * i) * W + 4LL * j;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    float row[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float acc = 0.f;
#pragma unroll
      for (int f = 0; f < 16; ++f) acc = fmaf(co[f], basis(4 * p + q, f), acc);
      row[q] = acc;
    }
    *reinterpret_cast<float4*>(dst + (long long)p * W) =
        make_float4(row[0], row[1], row[2], row[3]);
  }
}

int launch_blocks(long long total) {
  return (int)((total + kThreads - 1) / kThreads);
}

bool bad_shape(int B, int C, int H, int W, long long x_bstride,
               long long z_bstride) {
  // float4 rows of the pixel side: each image starts 16-byte aligned
  return B < 0 || C < 0 || H % 4 || W % 4 || x_bstride % 4 ||
         x_bstride < (long long)C * H * W || z_bstride < (long long)C * H * W;
}

}  // namespace

// x: (B, C, H, W) float32, image b at x + b * x_bstride -> z: (B, 16*C,
// H/4, W/4), image b at z + b * z_bstride (strides in floats).
extern "C" int wavelet_dec_f32(const void* x, void* z, int B, int C, int H,
                               int W, long long x_bstride,
                               long long z_bstride, void* stream) {
  if (bad_shape(B, C, H, W, x_bstride, z_bstride))
    return (int)cudaErrorInvalidValue;
  const long long total = (long long)B * C * (H / 4) * (W / 4);
  if (total == 0) return (int)cudaSuccess;
  wavelet_dec_kernel<<<launch_blocks(total), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(z), C, H, W,
      x_bstride, z_bstride, total);
  return (int)cudaGetLastError();
}

// z: (B, 16*C, H/4, W/4) float32, image b at z + b * z_bstride -> x: (B, C,
// H, W), image b at x + b * x_bstride (strides in floats).
extern "C" int wavelet_rec_f32(const void* z, void* x, int B, int C, int H,
                               int W, long long z_bstride,
                               long long x_bstride, void* stream) {
  if (bad_shape(B, C, H, W, x_bstride, z_bstride))
    return (int)cudaErrorInvalidValue;
  const long long total = (long long)B * C * (H / 4) * (W / 4);
  if (total == 0) return (int)cudaSuccess;
  wavelet_rec_kernel<<<launch_blocks(total), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(z), static_cast<float*>(x), C, H, W,
      z_bstride, x_bstride, total);
  return (int)cudaGetLastError();
}
