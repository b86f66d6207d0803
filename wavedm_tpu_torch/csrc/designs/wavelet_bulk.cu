// Not built: the build compiles csrc/*.cu, and this file sits in
// csrc/designs/.  A measured alternative to csrc/wavelet.cu with the same C
// entries, kept so that its times in PERF.md can be taken again: in a copy
// of the package, put this file in place of csrc/wavelet.cu and run
//   python3 chip_smoke.py --tree <copy> --phases kernels
// in turns with  python3 chip_smoke.py --phases kernels  on one card.
//
// Design: bulk (TMA) copies through shared memory (below).
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
// not (a tensor viewed off a 16-byte boundary, or rows of w % 4 floats).
//
// What held the first design (one thread per 4x4 block) back: each
// thread moved its 64 coefficient bytes as 16 scalar 4-byte accesses, one
// to each of 16 planes, beside 4 float4 pixel rows -- 20 memory
// instructions for 128 bytes -- and its one-shot threads left nothing to
// overlap one block's loads with another's stores but the scheduler: 75-85%
// of the bound at 2 and 8 images.  A register tile of 4 blocks a thread
// (float4 on both sides) measured no better on the DWT and 1.7x slower on
// the IWT: its float4 pixel accesses sit 64 bytes apart across a warp.
//
// This design moves both sides by bulk (TMA) copies, 16-byte units issued
// by one thread and completed by the copy engine.  An item is one (b, c, i)
// row of 4x4 blocks, cut into chunks of at most kChunk blocks (a multiple
// of 4): its 4 pixel rows and its 16 coefficient rows (one a plane) are
// each one contiguous run.  A persistent block walks its items with
// kStages of them in flight into shared memory (an mbarrier each), turns
// each with one thread a 4x4 block (shared-memory reads and writes of
// neighbouring threads side by side), and writes it back by bulk stores
// from one of two output buffers while the next item is computed.  The
// grid is sized to the card (blocks per SM from the occupancy API, asked
// once per process).  Each coefficient keeps the arithmetic of the first
// design (16 fmaf in the order k = 0..15, the basis folded into constants,
// never TF32), so the outputs are equal to it bit for bit.  Where the
// coefficient side is not 16-byte aligned (its start, batch stride, or
// w % 4), threads move that side by scalar accesses, coalesced along the
// row, in the same launch; the pixel side always goes by bulk copies.
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
constexpr int kChunk = 128;      // 4x4 blocks an item holds at most
constexpr int kStages = 3;       // items in flight into shared memory
// one item's side: 4 pixel rows of 4 * kChunk floats, or 16 coefficient
// rows of kChunk floats (8 KB)
constexpr int kItemFloats = 16 * kChunk;

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
// One bulk copy of `bytes` contiguous bytes (a multiple of 16, both ends
// 16-byte aligned) into this block's shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// One bulk copy from this block's shared memory to device memory, in the
// current bulk group.
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(dst), "r"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// the committed bulk stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// ... and their writes are done
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// this thread's shared-memory writes, seen by the bulk copies after a
// barrier
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Where the items lie.  Offsets and strides in floats.
struct Geometry {
  int C, H, W, h, w;
  int chunk;            // blocks an item, a multiple of 4 (the last fewer)
  int chunks;           // items a row of blocks
  int total;            // items: B * C * h * chunks
  long long px_bstride, co_bstride;
  long long plane;      // h * w
  long long fstride;    // C * plane: from one filter's planes to the next
  bool co_vec;          // coefficient rows of every item 16-byte aligned
};

struct Item {
  long long px, co;     // offsets of its first pixel and first coefficient
  int n;                // its blocks
};

__device__ __forceinline__ Item locate(const Geometry& g, int it) {
  const int q = it % g.chunks;
  int r = it / g.chunks;
  const int i = r % g.h;
  r /= g.h;
  const int c = r % g.C;
  const int b = r / g.C;
  const int j0 = q * g.chunk;
  Item t;
  t.px = b * g.px_bstride + ((long long)c * g.H + 4LL * i) * g.W + 4LL * j0;
  t.co = b * g.co_bstride + c * g.plane + (long long)i * g.w + j0;
  t.n = min(g.chunk, g.w - j0);
  return t;
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

// Shared-memory layout of an item's side: pixel row p of block j at
// [p * 4 * kChunk + 4 * j], 4 floats; coefficient f of block j at
// [f * kChunk + j].
template <bool kDec>
__device__ __forceinline__ void load_item(const float* src,
                                          const Geometry& g, const Item& t,
                                          float* stage, uint32_t bar) {
  mbar_expect_tx(bar, 64u * t.n);   // 4 rows of 16n bytes, 16 rows of 4n
  if (kDec) {
#pragma unroll
    for (int p = 0; p < 4; ++p)
      bulk_load(smem_u32(stage + p * 4 * kChunk), src + t.px + p * g.W,
                16u * t.n, bar);
  } else {
#pragma unroll
    for (int f = 0; f < 16; ++f)
      bulk_load(smem_u32(stage + f * kChunk), src + t.co + f * g.fstride,
                4u * t.n, bar);
  }
}

template <bool kDec>
__device__ __forceinline__ void store_item(float* dst, const Geometry& g,
                                           const Item& t,
                                           const float* stage) {
  if (kDec) {
#pragma unroll
    for (int f = 0; f < 16; ++f)
      bulk_store(dst + t.co + f * g.fstride, smem_u32(stage + f * kChunk),
                 4u * t.n);
  } else {
#pragma unroll
    for (int p = 0; p < 4; ++p)
      bulk_store(dst + t.px + p * g.W, smem_u32(stage + p * 4 * kChunk),
                 16u * t.n);
  }
  bulk_commit();
}

// kDec: src pixels -> dst coefficients (the DWT); else src coefficients ->
// dst pixels (the IWT).
template <bool kDec>
__global__ void __launch_bounds__(kThreads)
    wavelet_kernel(const float* __restrict__ src, float* __restrict__ dst,
                   Geometry g) {
  __shared__ __align__(128) float s_in[kStages][kItemFloats];
  __shared__ __align__(128) float s_out[2][kItemFloats];
  __shared__ __align__(8) uint64_t s_bar[kStages];
  const bool bulk_in = kDec || g.co_vec;    // the pixel side always is
  const bool bulk_out = !kDec || g.co_vec;
  const int tid = threadIdx.x;
  const int step = gridDim.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(smem_u32(&s_bar[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int k = 0; bulk_in && k < kStages; ++k) {
      const int it = blockIdx.x + k * step;
      if (it < g.total)
        load_item<kDec>(src, g, locate(g, it), s_in[k],
                        smem_u32(&s_bar[k]));
    }
  }
  __syncthreads();
  int k = 0;
  for (int it = blockIdx.x; it < g.total; it += step, ++k) {
    const int s = k % kStages;
    const Item t = locate(g, it);
    const float* in = s_in[s];
    float* out = s_out[k & 1];
    if (bulk_in) mbar_wait(smem_u32(&s_bar[s]), (k / kStages) & 1);
    for (int j = tid; j < t.n; j += kThreads) {
      if (kDec) {
        float px[16];
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const float4 v =
              *reinterpret_cast<const float4*>(in + p * 4 * kChunk + 4 * j);
          px[4 * p + 0] = v.x;
          px[4 * p + 1] = v.y;
          px[4 * p + 2] = v.z;
          px[4 * p + 3] = v.w;
        }
#pragma unroll
        for (int f = 0; f < 16; ++f) {
          if (bulk_out)
            out[f * kChunk + j] = dwt(px, f);
          else
            dst[t.co + f * g.fstride + j] = dwt(px, f);
        }
      } else {
        float co[16];
#pragma unroll
        for (int f = 0; f < 16; ++f)
          co[f] = bulk_in ? in[f * kChunk + j]
                          : __ldg(src + t.co + f * g.fstride + j);
#pragma unroll
        for (int p = 0; p < 4; ++p)
          *reinterpret_cast<float4*>(out + p * 4 * kChunk + 4 * j) =
              make_float4(iwt(co, 4 * p + 0), iwt(co, 4 * p + 1),
                          iwt(co, 4 * p + 2), iwt(co, 4 * p + 3));
      }
    }
    if (bulk_out) {
      fence_proxy_async();
      // the previous item's stores have read the buffer the next one fills
      if (tid == 0) bulk_wait_read();
    }
    __syncthreads();      // `in` read through, `out` written
    if (tid == 0) {
      if (bulk_out) store_item<kDec>(dst, g, t, out);
      const int next = it + kStages * step;
      if (bulk_in && next < g.total)
        load_item<kDec>(src, g, locate(g, next), s_in[s],
                        smem_u32(&s_bar[s]));
    }
  }
  if (tid == 0 && bulk_out) bulk_wait();
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
            &p.dec_blocks, wavelet_kernel<true>, kThreads, 0) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &p.rec_blocks, wavelet_kernel<false>, kThreads, 0) !=
            cudaSuccess)
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
  // rows of blocks cut into equal chunks of at most kChunk, a multiple of 4
  const int cuts = (g->w + kChunk - 1) / kChunk;
  g->chunk = ((g->w + cuts - 1) / (cuts > 0 ? cuts : 1) + 3) / 4 * 4;
  g->chunks = g->chunk > 0 ? (g->w + g->chunk - 1) / g->chunk : 0;
  const long long total = (long long)B * C * g->h * g->chunks;
  if (total > INT_MAX / 2) return false;   // it + kStages * step stays an int
  g->total = (int)total;
  g->px_bstride = px_bstride;
  g->co_bstride = co_bstride;
  g->plane = (long long)g->h * g->w;
  g->fstride = C * g->plane;
  // bulk copies of pixel rows: the pixel side starts 16-byte aligned
  if (g->total && reinterpret_cast<uintptr_t>(px) % 16) return false;
  g->co_vec = reinterpret_cast<uintptr_t>(co) % 16 == 0 &&
              (B < 2 || co_bstride % 4 == 0) && g->w % 4 == 0;
  return true;
}

int grid_for(int total, int blocks_per_sm) {
  const int fill = card_plan().sms * blocks_per_sm;
  return total < fill ? total : fill;
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
  wavelet_kernel<true><<<grid_for(g.total, card_plan().dec_blocks),
                         kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
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
  wavelet_kernel<false><<<grid_for(g.total, card_plan().rec_blocks),
                          kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(z), static_cast<float*>(x), g);
  return (int)cudaGetLastError();
}
