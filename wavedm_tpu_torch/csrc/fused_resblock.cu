// GroupNorm(32, eps) -> swish -> 3x3 SAME conv + bias on NCHW, float32 or
// bfloat16 compute, float32 statistics and float32 accumulation.
//
// Replaces: wavedm_tpu/ops/fused_resblock.py:67 _kernel (entry
// fused_gn_swish_conv:145 -> _forward:175, pallas_call at :198, pad scratch
// at :218).  Same function: per (sample, group) mean and E[x^2] - E[x]^2 in
// float32, the affine folded to y = x*a + b per (sample, channel), swish
// y*sigmoid(y) in float32, y rounded once to the compute dtype, the 3x3 conv
// over y zero-padded by one pixel (the border is zero AFTER normalize and
// swish, as the TPU kernel's zeroed pad scratch is), float32 accumulation,
// + bias in float32, one rounding to x's dtype.  x may be float32 or
// bfloat16 whatever the compute dtype; the output takes x's dtype.
//
// Bound on an H100 SXM: operations.  The conv is 2*N*H*W*9*Cin*Cout FLOP
// against (Cin + Cout)*N*H*W activations moved: at the flagship's 64x64
// 128->128 site that is 2,304 FLOP per element, far above the card's
// ~295 FLOP/byte bf16 ridge.  The flagship UNet's 44 sites are 58.81 GFLOP
// per 64x64 patch: 5.35 ms per 90-patch forward at the 989 TFLOP/s bf16
// dense peak, 79 ms in float32 at 67 TFLOP/s without tensor cores.
//
// Design:
//  - Launch 1 (gn_affine_kernel): one block per (n, g) streams the group's
//    contiguous NCHW segment once (gn_stats.cuh) and writes the folded
//    a[n, c] = rstd*gamma[c], b[n, c] = beta[c] - mean*a[n, c].
//  - Launch 2: implicit GEMM, M = N*H*W output pixels (flat n, h, w order),
//    N = Cout, K = 9*Cin.  An output tile is 128 consecutive pixels (whole
//    rows at 64x64, several images at 8x8) x 128 channels, walked in
//    32-channel chunks of Cin, each chunk through the 9 taps.  One
//    persistent block an SM loops over the tiles.
//  - The halo tile (the TPU kernel's pad scratch, cut to a block): per
//    chunk the block normalizes + swishes the x pixels its 9 taps can reach
//    ONCE, rounds them to the compute dtype and stores them channel-
//    contiguous, one 16-byte-padded shared-memory row per pixel.  The tile
//    is three runs of S = min(W, 130) pixels around the tile's pixels,
//    which overlap into one run of 128 + 2W + 2 pixels when W <= 130: tap
//    (dy, dx) of pixel i reads row i + 1 + dx + (1 + dy)*S.  A tap that
//    leaves the pixel's image (the SAME border, or the next image of a
//    multi-image tile) reads a row of zeros instead: the padding is applied
//    to y, by address.  Each x element is normalized (128 + 2S + 2)/128
//    times per output-channel tile (2.02x at 64x64), against 9x in a
//    per-tap gather.
//  - Warp specialization: 4 producer warps load x (NCHW, coalesced along
//    pixels), normalize, swish and store halo tiles into two buffers, one
//    chunk ahead of 8 math warps; named barriers hand each buffer over
//    (full) and back (empty), so the loads' latency never stalls the math.
//  - bfloat16: two math warpgroups, each 64 pixels x 128 channels through
//    wgmma.m64n128k16 (bf16 x bf16 -> f32), A from registers (ldmatrix
//    straight from the halo tile: every tap offset is a whole 16-byte
//    row, so any shift is legal), B from shared memory.  The wrapper lays
//    the weights out so that a chunk's 9 weight tiles are one contiguous
//    72 KB run in wgmma's core-matrix order; one thread fetches it with 18
//    TMA bulk copies of 4 KB into a double-buffered stage (an mbarrier
//    counts the bytes).  Weight traffic from L2 bounded the per-tap cp.async version
//    of this loop: 128 output pixels share each weight tile.
//  - float32: SIMT FMA (no TF32, for parity), 8 x 8 outputs a thread; A and
//    B are read from shared memory as 16-byte vectors (4 channels of a
//    pixel; 4 output channels); the weights, (9*Cin, Cout_pad) from the
//    wrapper, stream through 3 cp.async stages of one tap each.
//  - The epilogue adds the bias and rounds once; bfloat16 stages the tile
//    through the finished weight stage so that each warp stores 32
//    consecutive pixels of a channel.
//  - Small M (the 8x8 sites in training): the wrapper splits the Cin chunks
//    of a tile over `splits` tiles when that evens out the SMs' last round;
//    each writes float32 partials to a workspace and a third launch sums
//    them in a fixed order, adds the bias and rounds once (deterministic,
//    no atomics).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "gn_stats.cuh"

namespace {

using wavedm::to_f32;

constexpr int kGroups = 32;
constexpr int kStatThreads = 256;
constexpr int kBM = 128;      // output pixels a tile
constexpr int kBN = 128;      // output channels a tile
constexpr int kCK = 32;       // input channels a chunk (Cin % 32 == 0)
constexpr int kMaxSlots = 3 * (kBM + 2);   // halo tile rows at most

__device__ __forceinline__ float from_f32(float v, float) { return v; }
__device__ __forceinline__ __nv_bfloat16 from_f32(float v, __nv_bfloat16) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
// D(64 x 128, f32) += A(64 x 16, bf16, registers: each warp its 16 rows in
// the mma.m16n8k16 A layout) * B(16 x 128, bf16, shared memory, K-major, no
// swizzle), one warpgroup, asynchronous.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from reusing or reading registers that an in-flight
// wgmma still reads or writes.
__device__ __forceinline__ void fence_regs(uint32_t (&r)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
__device__ __forceinline__ void fence_regs(float (&r)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
// Shared-memory descriptor of a K-major, unswizzled bf16 operand whose 8 x 8
// core matrices (128 contiguous bytes) lie 128 bytes apart along N and 2 KB
// apart along K.
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(2048 >> 4) << 16 |
         (uint64_t)(128 >> 4) << 32;
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
// Arrive on the barrier, expecting `bytes` more to land before its phase
// completes.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
// One bulk (TMA) copy of `bytes` contiguous bytes into shared memory; the
// barrier's transaction count tracks its completion.
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
__device__ __forceinline__ float4 lds128(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
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
constexpr int kProdThreads = 128;   // 4 producer warps, after the math warps
// named barriers (0 is __syncthreads): the math warps' per-tap barrier, and
// full / empty for each of the two halo-tile buffers
constexpr int kBarMath = 1, kBarFull = 2, kBarEmpty = 4;

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

struct Params {
  const void* x;       // (N, Cin, H, W), TX
  const float* a;      // (N, Cin) folded scale
  const float* b;      // (N, Cin) folded shift
  const void* wk;      // weights, the compute dtype's layout
  const float* bias;   // (Cout,)
  void* out;           // (N, Cout, H, W), TX
  float* ws;           // (splits, CoutP, M) partials when splits > 1
  int Cin, H, W, HW, M, Cout, CoutP;
  int S, T;            // halo run length, halo tile rows
  int chunks, splits;
  int m_tiles, n_tiles, tiles;   // tiles = m_tiles * n_tiles * splits
};

// An output tile and its range of Cin chunks; n fastest, so the blocks
// that run together share x in L2.
struct Tile {
  int m0, n0, z, c_begin, c_end;
  __device__ __forceinline__ Tile(const Params& p, int t) {
    const int nb = t % p.n_tiles, r = t / p.n_tiles;
    z = r % p.splits;
    m0 = (r / p.splits) * kBM;
    n0 = nb * kBN;
    c_begin = z * p.chunks / p.splits;
    c_end = (z + 1) * p.chunks / p.splits;
  }
};

// Tap (dy, dx) of a pixel needs these border flags: bit 0 h > 0, bit 1
// h < H-1, bit 2 w > 0, bit 3 w < W-1.
__device__ __forceinline__ int tap_need(int dy, int dx) {
  return (dy < 0) | (dy > 0) << 1 | (dx < 0) << 2 | (dx > 0) << 3;
}
__device__ __forceinline__ uint32_t border_flags(const Params& p, int m) {
  if (m >= p.M) return 0;   // never stored; its reads stay inside the tile
  const int hw = m % p.HW, h = hw / p.W, w = hw - h * p.W;
  return (h > 0) | (h < p.H - 1) << 1 | (w > 0) << 2 | (w < p.W - 1) << 3;
}

template <typename TC>
struct TileRow {
  static constexpr int kVec = 16 / sizeof(TC);               // per 16 bytes
  static constexpr int kBytes = kCK * (int)sizeof(TC) + 16;  // +16: no
                                                             // conflicts
};

// The producer warps: thread t owns tile rows t, t + 128, ... of every
// tile.  Slot s holds pixel m0 - W - 1 + (s / S)*W + s % S; rows whose
// pixel lies outside [0, M) are never read and stay unwritten.
template <typename TX, typename TC, int kMath>
struct Producer {
  static constexpr int kSlots = (kMaxSlots + kProdThreads - 1) / kProdThreads;
  static constexpr int kVec = TileRow<TC>::kVec;
  int img[kSlots], hw[kSlots];   // img < 0: nothing to produce

  __device__ __forceinline__ void begin_tile(const Params& p, int m0) {
    const int t = threadIdx.x - kMath;
#pragma unroll
    for (int q = 0; q < kSlots; ++q) {
      const int s = t + q * kProdThreads;
      const int pix = m0 - p.W - 1 + (s / p.S) * p.W + s % p.S;
      img[q] = -1;
      hw[q] = 0;
      if (s < p.T && pix >= 0 && pix < p.M) {
        img[q] = pix / p.HW;
        hw[q] = pix - img[q] * p.HW;
      }
    }
  }

  // Two rows' 2 x 32 loads in flight at a time.
  __device__ __forceinline__ void produce(const Params& p, int chunk,
                                          unsigned char* tile) const {
    const TX* x = static_cast<const TX*>(p.x);
    const int t = threadIdx.x - kMath;
#pragma unroll
    for (int q0 = 0; q0 < kSlots; q0 += 2) {
      TX raw[2][kCK];
#pragma unroll
      for (int q = q0; q < q0 + 2 && q < kSlots; ++q) {
        if (img[q] < 0) continue;
        const TX* src =
            x + ((long long)img[q] * p.Cin + chunk * kCK) * p.HW + hw[q];
#pragma unroll
        for (int c = 0; c < kCK; ++c)
          raw[q - q0][c] = __ldg(src + (long long)c * p.HW);
      }
#pragma unroll
      for (int q = q0; q < q0 + 2 && q < kSlots; ++q) {
        if (img[q] < 0) continue;
        const float* a = p.a + img[q] * p.Cin + chunk * kCK;
        const float* b = p.b + img[q] * p.Cin + chunk * kCK;
        unsigned char* row =
            tile + (t + q * kProdThreads) * TileRow<TC>::kBytes;
#pragma unroll
        for (int g = 0; g < kCK / kVec; ++g) {
          float y[kVec];
#pragma unroll
          for (int e4 = 0; e4 < kVec; e4 += 4) {
            const float4 av =
                __ldg(reinterpret_cast<const float4*>(a + g * kVec + e4));
            const float4 bv =
                __ldg(reinterpret_cast<const float4*>(b + g * kVec + e4));
            const float af[4] = {av.x, av.y, av.z, av.w};
            const float bf[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float v =
                  to_f32(raw[q - q0][g * kVec + e4 + e]) * af[e] + bf[e];
              y[e4 + e] = __fdividef(v, 1.f + __expf(-v));   // swish, f32
            }
          }
          store16(row + g * 16, y);
        }
      }
    }
  }

  static __device__ __forceinline__ void store16(unsigned char* dst,
                                                 const float (&y)[4]) {
    *reinterpret_cast<float4*>(dst) = make_float4(y[0], y[1], y[2], y[3]);
  }
  static __device__ __forceinline__ void store16(unsigned char* dst,
                                                 const float (&y)[8]) {
    uint4 v;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(y[2 * i], y[2 * i + 1]);
    *reinterpret_cast<uint4*>(dst) = v;
  }
};

// bfloat16 on the tensor cores: two warpgroups, each 64 pixels x 128
// channels through wgmma.m64n128k16 with A from registers (each warp loads
// its 16 pixel rows of a tap from the halo tile by ldmatrix) and B, the
// chunk's 9 weight tiles, from shared memory.  The next tap's ldmatrix
// overlaps the current tap's wgmma.
struct WgmmaBf16 {
  using TC = __nv_bfloat16;
  static constexpr int kThreads = 256;
  static constexpr int kTapsPerStage = 9;   // a chunk's 9 weight tiles
  static constexpr int kStages = 2;         // double-buffered
  static constexpr int kBRowBytes = kBN * 2;   // per k row (core-matrix
                                               // blocked, see copy_stage)
  static constexpr int kBTapBytes = kCK * kBRowBytes;
  static constexpr int kRowBytes = TileRow<TC>::kBytes;

  float acc[64];
  int slot0;         // tile row of this lane's pixel
  uint32_t flags;    // its border flags
  int lane, warp;

  __device__ __forceinline__ void begin_tile(const Params& p, int m0) {
    lane = threadIdx.x & 31;
    warp = threadIdx.x >> 5;
    const int ml = warp * 16 + (lane & 15);
    slot0 = ml + 1 + p.S;
    flags = border_flags(p, m0 + ml);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  }

  // The chunk's 9 weight tiles: the wrapper lays the weights out as
  // (CoutP/128, Cin/32, 9, 4, 16, 8, 8) = (n tile, chunk, tap, k8 block q,
  // n8 block j, n % 8, k % 8), so that a stage is one contiguous 72 KB run
  // in the order wgmma reads it: each 8 x 8 core matrix (8 channels n, 8 k
  // of one n per 16-byte row) is 128 contiguous bytes, core matrix (q, j)
  // of a tap at (16*q + j)*128.  One thread copies it in 18 bulk copies of
  // 4 KB (on the H100 2% faster per forward than 9 or 36, 25% than 72).
  static constexpr bool kBulk = true;
  static __device__ __forceinline__ void copy_stage(const Params& p,
                                                    uint32_t stage, int,
                                                    int chunk, int n0,
                                                    uint32_t bar) {
    constexpr int kBytes = kTapsPerStage * kBTapBytes;
    const unsigned char* wk = static_cast<const unsigned char*>(p.wk) +
                              ((long long)(n0 / kBN) * p.chunks + chunk) * kBytes;
    constexpr int kPiece = kBTapBytes / 2;
    mbar_expect_tx(bar, kBytes);
#pragma unroll
    for (int i = 0; i < kBytes / kPiece; ++i)
      bulk_copy(stage + i * kPiece, wk + i * kPiece, kPiece, bar);
  }

  __device__ __forceinline__ void stage(const Params& p, uint32_t a_tile,
                                        uint32_t zero, uint32_t b_stage,
                                        int) {
    uint32_t a[9][2][4];
    wgmma_fence();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3 - 1, dx = tap % 3 - 1;
      const uint32_t need = tap_need(dy, dx);
      const uint32_t addr =
          ((flags & need) == need
               ? a_tile + (slot0 + dy * p.S + dx) * kRowBytes
               : zero) +
          (lane >> 4) * 16;
      ldsm_x4(addr, a[tap][0]);
      ldsm_x4(addr + 32, a[tap][1]);
      wgmma_fence();
      const uint32_t b = b_stage + tap * kBTapBytes;
      wgmma_m64n128k16(acc, a[tap][0], desc_kmajor(b));
      wgmma_m64n128k16(acc, a[tap][1], desc_kmajor(b + 2 * 2048));
      wgmma_commit();
      if (tap > 0) {
        wgmma_wait<1>();   // tap - 1's products are done with its A
        fence_regs(a[tap - 1][0]);
        fence_regs(a[tap - 1][1]);
      }
    }
    wgmma_wait<0>();
    fence_regs(a[8][0]);
    fence_regs(a[8][1]);
    fence_regs(acc);
  }

  // fn(m_local, channel_local, value) for every accumulator
  template <typename Fn>
  __device__ __forceinline__ void for_each(Fn&& fn) const {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        fn(warp * 16 + g + 8 * (e >> 1), j * 8 + 2 * t + (e & 1),
           acc[4 * j + e]);
  }
};

// float32 SIMT: math thread (tm, tn) owns pixels tm + 16*i and channels
// 4*tn + j, 64 + 4*tn + j (i < 8, j < 4).  A quarter warp reads 8
// consecutive tile rows (16 bytes each, rows 144 bytes apart: conflict-free)
// and one broadcast weight vector.
struct SimtF32 {
  using TC = float;
  static constexpr int kThreads = 256;
  static constexpr int kTapsPerStage = 1;
  static constexpr int kStages = 3;
  static constexpr int kBRowBytes = kBN * 4;
  static constexpr int kRowBytes = TileRow<TC>::kBytes;

  float acc[8][8];
  uint32_t flags;    // a nibble per pixel
  int tm, tn, slot0;

  __device__ __forceinline__ void begin_tile(const Params& p, int m0) {
    tm = threadIdx.x & 15;
    tn = threadIdx.x >> 4;
    slot0 = tm + 1 + p.S;
    flags = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      flags |= border_flags(p, m0 + tm + 16 * i) << (4 * i);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    }
  }

  // one tap of a chunk (a stage is one tap)
  __device__ __forceinline__ void stage(const Params& p, uint32_t a_tile,
                                        uint32_t zero, uint32_t b_stage,
                                        int tap) {
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    const uint32_t need = tap_need(dy, dx);
    const uint32_t base = a_tile + (slot0 + dy * p.S + dx) * kRowBytes;
    uint32_t a_addr[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const bool ok = ((flags >> (4 * i)) & need) == need;
      a_addr[i] = ok ? base + 16 * i * kRowBytes : zero;
    }
    const uint32_t b_lane = b_stage + tn * 16;
#pragma unroll 2
    for (int k4 = 0; k4 < kCK / 4; ++k4) {
      float4 av[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) av[i] = lds128(a_addr[i] + k4 * 16);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t row = b_lane + (k4 * 4 + kk) * kBRowBytes;
        const float4 b0 = lds128(row), b1 = lds128(row + 256);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float a = kk == 0 ? av[i].x
                          : kk == 1 ? av[i].y
                          : kk == 2 ? av[i].z
                                    : av[i].w;
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a, bv[j], acc[i][j]);
        }
      }
    }
  }

  // The weight tile of one tap: rows k of the wrapper's (9*Cin, CoutP)
  // layout, 128 channels each, 512 bytes apart, by cp.async.
  static constexpr bool kBulk = false;
  static __device__ __forceinline__ void copy_stage(const Params& p,
                                                    uint32_t stage, int tap,
                                                    int chunk, int n0,
                                                    uint32_t) {
    constexpr int kPerRow = kBN * 4 / 16;   // 16-byte pieces
    constexpr int kPieces = kCK * kPerRow / kThreads;
    const float* wk = static_cast<const float*>(p.wk) +
                      ((long long)tap * p.Cin + chunk * kCK) * p.CoutP + n0;
#pragma unroll
    for (int q = 0; q < kPieces; ++q) {
      const int v = threadIdx.x + q * kThreads;
      const int r = v / kPerRow, col = v % kPerRow;
      cp_async16(stage + r * kBRowBytes + col * 16,
                 wk + (long long)r * p.CoutP + col * 4);
    }
  }

  template <typename Fn>
  __device__ __forceinline__ void for_each(Fn&& fn) const {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        fn(tm + 16 * i, 4 * tn + (j & 3) + 64 * (j >> 2), acc[i][j]);
  }
};

template <typename Math>
struct Layout {
  static constexpr int kRowBytes = Math::kRowBytes;
  static constexpr int kStageBytes =
      Math::kTapsPerStage * kCK * Math::kBRowBytes;
  // halo tile buffers 0 and 1, one zero row, the weight ring
  static __host__ __device__ int tile_bytes(int T) { return T * kRowBytes; }
  static __host__ __device__ int zero_offset(int T) { return 2 * tile_bytes(T); }
  static __host__ __device__ int ring_offset(int T) {
    return zero_offset(T) + kRowBytes;
  }
  // one mbarrier a stage (bulk copies)
  static __host__ __device__ int bar_offset(int T) {
    return ring_offset(T) + Math::kStages * kStageBytes;
  }
  static __host__ __device__ int smem_bytes(int T) {
    return bar_offset(T) + Math::kStages * 8;
  }
};

// The math warps' walk over weight stages (kTapsPerStage taps of one
// (tile, chunk)), kStages - 1 stages ahead of the products.
template <typename Math>
struct StageCursor {
  int tile, chunk, c_end, tap0, n0;
  __device__ __forceinline__ void start(const Params& p, int t) {
    tile = t;
    tap0 = 0;
    if (tile < p.tiles) {
      const Tile tl(p, tile);
      chunk = tl.c_begin;
      c_end = tl.c_end;
      n0 = tl.n0;
    }
  }
  __device__ __forceinline__ bool valid(const Params& p) const {
    return tile < p.tiles;
  }
  __device__ __forceinline__ void advance(const Params& p) {
    if ((tap0 += Math::kTapsPerStage) < 9) return;
    tap0 = 0;
    if (++chunk < c_end) return;
    start(p, tile + gridDim.x);
  }
  // the stage's weight tiles into the ring, by the math threads
  __device__ __forceinline__ void copy(const Params& p, uint32_t stage,
                                       uint32_t bar) const {
    Math::copy_stage(p, stage, tap0, chunk, n0, bar);
  }
};

// Output tile -> out (+ bias, one rounding to TX) or to the split-K
// workspace.  With a staging buffer (128 x 132 float32), the accumulators
// go through shared memory so that each warp stores 32 consecutive pixels
// of a channel; without one, each thread stores its own.
template <typename TX, typename Math>
__device__ __forceinline__ void store_tile(const Params& p, const Tile& tl,
                                           const Math& math, float* stage) {
  constexpr int kPitch = kBM + 4;   // conflict-free fragment writes
  if (stage == nullptr) {
    math.for_each([&](int ml, int nl, float v) {
      const int m = tl.m0 + ml, co = tl.n0 + nl;
      if (m >= p.M) return;
      if (p.splits > 1) {
        p.ws[((long long)tl.z * p.CoutP + co) * p.M + m] = v;
      } else if (co < p.Cout) {
        const int img = m / p.HW, hw = m - img * p.HW;
        static_cast<TX*>(p.out)[((long long)img * p.Cout + co) * p.HW + hw] =
            from_f32(v + __ldg(p.bias + co), TX());
      }
    });
    return;
  }
  // bias added here (not to split-K partials), where the loads batch
  const bool add_bias = p.splits == 1;
  bar_sync(kBarMath, Math::kThreads);   // the weight stage is free
  math.for_each([&](int ml, int nl, float v) {
    const int co = min(tl.n0 + nl, p.Cout - 1);   // padding: not stored
    stage[nl * kPitch + ml] = add_bias ? v + __ldg(p.bias + co) : v;
  });
  bar_sync(kBarMath, Math::kThreads);
  const int ml = threadIdx.x % kBM;
  const int m = tl.m0 + ml;
  const int img = m / p.HW, hw = m - img * p.HW;
  constexpr int kStep = Math::kThreads / kBM;
  if (m < p.M) {
    if (!add_bias) {
      float* ws = p.ws + ((long long)tl.z * p.CoutP + tl.n0) * p.M + m;
#pragma unroll 8
      for (int nl = threadIdx.x / kBM; nl < kBN; nl += kStep)
        ws[(long long)nl * p.M] = stage[nl * kPitch + ml];
    } else {
      TX* out = static_cast<TX*>(p.out) +
                ((long long)img * p.Cout + tl.n0) * p.HW + hw;
      const int n_end = min(kBN, p.Cout - tl.n0);
#pragma unroll 8
      for (int nl = threadIdx.x / kBM; nl < n_end; nl += kStep)
        out[(long long)nl * p.HW] = from_f32(stage[nl * kPitch + ml], TX());
    }
  }
  // the stage buffer's next writer is a bulk copy (the async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <typename TX, typename Math>
__device__ __forceinline__ void math_role(const Params& p,
                                          unsigned char* smem) {
  using L = Layout<Math>;
  constexpr int kAll = Math::kThreads + kProdThreads;
  // the bf16 ring's stage (a whole chunk of weights) is free between the
  // last tap of a tile and the next chunk's barrier: the epilogue stages
  // through it
  constexpr bool kStaged = L::kStageBytes >= kBN * (kBM + 4) * 4;
  const uint32_t tiles = smem_u32(smem);
  const uint32_t zero = tiles + L::zero_offset(p.T);
  const uint32_t ring = tiles + L::ring_offset(p.T);
  int total = 0;   // chunks this block runs
  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
    const Tile tl(p, t);
    total += tl.c_end - tl.c_begin;
  }
  const uint32_t bars = tiles + L::bar_offset(p.T);
  const bool issuer = !Math::kBulk || threadIdx.x == 0;
  StageCursor<Math> ld;
  ld.start(p, blockIdx.x);
#pragma unroll
  for (int st = 0; st < Math::kStages - 1; ++st) {
    if (ld.valid(p)) {
      if (issuer) ld.copy(p, ring + st * L::kStageBytes, bars + st * 8);
      ld.advance(p);
    }
    cp_async_commit();
  }
  Math math;
  int seq = 0, stage = 0;
  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
    const Tile tl(p, t);
    math.begin_tile(p, tl.m0);
    for (int c = tl.c_begin; c < tl.c_end; ++c, ++seq) {
      const int buf = seq & 1;
      bar_sync(kBarFull + buf, kAll);   // the producers filled it
      const uint32_t a_tile = tiles + buf * L::tile_bytes(p.T);
#pragma unroll 1
      for (int tap0 = 0; tap0 < 9; tap0 += Math::kTapsPerStage, ++stage) {
        // the oldest stage is free once every math thread is past it;
        // then this stage's weights must have landed
        const int nxt = (stage + Math::kStages - 1) % Math::kStages;
        if (!Math::kBulk) cp_async_wait<Math::kStages - 2>();
        bar_sync(kBarMath, Math::kThreads);
        if (ld.valid(p)) {
          if (issuer)
            ld.copy(p, ring + nxt * L::kStageBytes, bars + nxt * 8);
          ld.advance(p);
        }
        cp_async_commit();
        if (Math::kBulk)
          mbar_wait(bars + (stage % Math::kStages) * 8,
                    (stage / Math::kStages) & 1);
        math.stage(p, a_tile, zero,
                   ring + (stage % Math::kStages) * L::kStageBytes, tap0);
      }
      // hand the buffer back, unless no fill of it follows
      if (seq + 2 < total) bar_arrive(kBarEmpty + buf, kAll);
    }
    store_tile<TX>(p, tl, math,
                   kStaged ? reinterpret_cast<float*>(
                                 smem + L::ring_offset(p.T) +
                                 ((stage + Math::kStages - 1) % Math::kStages) *
                                     L::kStageBytes)
                           : nullptr);
  }
  cp_async_wait<0>();
}

template <typename TX, typename Math>
__device__ __forceinline__ void producer_role(const Params& p,
                                              unsigned char* smem) {
  using TC = typename Math::TC;
  constexpr int kAll = Math::kThreads + kProdThreads;
  const int tile_bytes = p.T * TileRow<TC>::kBytes;
  Producer<TX, TC, Math::kThreads> prod;
  int seq = 0;
  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
    const Tile tl(p, t);
    prod.begin_tile(p, tl.m0);
    for (int c = tl.c_begin; c < tl.c_end; ++c, ++seq) {
      const int buf = seq & 1;
      if (seq >= 2) bar_sync(kBarEmpty + buf, kAll);   // math is done
      prod.produce(p, c, smem + buf * tile_bytes);
      __threadfence_block();
      bar_arrive(kBarFull + buf, kAll);
    }
  }
}

template <typename TX, typename Math>
__global__ void __launch_bounds__(Math::kThreads + kProdThreads, 1)
    conv_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  using L = Layout<Math>;
  for (int i = threadIdx.x; i < Math::kRowBytes / 16; i += blockDim.x)
    reinterpret_cast<uint4*>(smem + L::zero_offset(p.T))[i] =
        make_uint4(0, 0, 0, 0);
  if (Math::kBulk && threadIdx.x == 0) {
    for (int st = 0; st < Math::kStages; ++st)
      mbar_init(smem_u32(smem) + L::bar_offset(p.T) + st * 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x < Math::kThreads)
    math_role<TX, Math>(p, smem);
  else
    producer_role<TX, Math>(p, smem);
}

// Launch 3 (split K only): out = sum of the partials in split order + bias,
// one rounding.  Consecutive threads take consecutive pixels of a channel.
constexpr int kReduceThreads = 256;
template <typename TX>
__global__ void __launch_bounds__(kReduceThreads)
    splitk_reduce_kernel(const float* __restrict__ ws,
                         const float* __restrict__ bias, TX* __restrict__ out,
                         int M, int HW, int Cout, int CoutP, int splits) {
  const long long total = (long long)Cout * M;
  for (long long idx = blockIdx.x * (long long)kReduceThreads + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * kReduceThreads) {
    const int co = (int)(idx / M), m = (int)(idx - (long long)co * M);
    float v = 0.f;
    for (int z = 0; z < splits; ++z)
      v += ws[((long long)z * CoutP + co) * M + m];
    const int img = m / HW, hw = m - img * HW;
    out[((long long)img * Cout + co) * HW + hw] = from_f32(v + bias[co], TX());
  }
}

template <typename TX, typename Math>
cudaError_t launch_conv(Params& p, cudaStream_t s) {
  constexpr int kThreads = Math::kThreads + kProdThreads;
  auto kernel = conv_kernel<TX, Math>;
  const int smem = Layout<Math>::smem_bytes(p.T);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Layout<Math>::smem_bytes(kMaxSlots));
  int device = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int grid = std::min(p.tiles, sms * per_sm);
  kernel<<<grid, kThreads, smem, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return err;
  const long long total = (long long)p.Cout * p.M;
  const unsigned blocks = (unsigned)std::min<long long>(
      (total + kReduceThreads - 1) / kReduceThreads, 65535);
  splitk_reduce_kernel<TX><<<blocks, kReduceThreads, 0, s>>>(
      p.ws, p.bias, static_cast<TX*>(p.out), p.M, p.HW, p.Cout, p.CoutP,
      p.splits);
  return cudaGetLastError();
}

template <typename TX, typename Math>
int launch(const void* x, const void* gamma, const void* beta, const void* wk,
           const void* bias, void* ab, void* ws, void* out, int N, int Cin,
           int H, int W, int Cout, int CoutP, int splits, float eps,
           void* stream) {
  const long long M = (long long)N * H * W;
  if (N <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cin % kCK || Cout <= 0 ||
      CoutP < Cout || CoutP % kBN ||
      M + 2LL * W + 2 * kBM >= (1LL << 31) ||
      (long long)N * Cin >= (1LL << 31) || splits < 1 ||
      splits > Cin / kCK || (splits > 1 && ws == nullptr) ||
      (M + kBM - 1) / kBM * (CoutP / kBN) * splits >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* a = static_cast<float*>(ab);
  float* b = a + (long long)N * Cin;
  gn_affine_kernel<TX><<<N * kGroups, kStatThreads, 0, s>>>(
      static_cast<const TX*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), a, b, Cin, H * W, eps);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  Params p;
  p.x = x;
  p.a = a;
  p.b = b;
  p.wk = wk;
  p.bias = static_cast<const float*>(bias);
  p.out = out;
  p.ws = static_cast<float*>(ws);
  p.Cin = Cin;
  p.H = H;
  p.W = W;
  p.HW = H * W;
  p.M = (int)M;
  p.Cout = Cout;
  p.CoutP = CoutP;
  p.S = W < kBM + 2 ? W : kBM + 2;
  p.T = kBM + 2 * p.S + 2;
  p.chunks = Cin / kCK;
  p.splits = splits;
  p.m_tiles = (int)((M + kBM - 1) / kBM);
  p.n_tiles = CoutP / kBN;
  p.tiles = p.m_tiles * p.n_tiles * splits;
  return (int)launch_conv<TX, Math>(p, s);
}

}  // namespace

// x: (N, Cin, H, W) contiguous, float32 (x_bf16 = 0) or bfloat16 (1);
// gamma, beta: (Cin,) float32; wk: the compute dtype's weight layout
// (ops/fused_resblock.py weight_layout), zero past Cout; bias: (Cout,)
// float32; ab: 2*N*Cin float32 scratch; ws: splits*CoutP*N*H*W float32
// scratch when splits > 1 (else may be null); out: (N, Cout, H, W) in x's
// dtype.  splits: each tile's Cin chunks split over that many tiles,
// 1 <= splits <= Cin/32.
extern "C" int fused_gn_swish_conv_f32(const void* x, const void* gamma,
                                       const void* beta, const void* wk,
                                       const void* bias, void* ab, void* ws,
                                       void* out, int N, int Cin, int H,
                                       int W, int Cout, int CoutP, int splits,
                                       int x_bf16, float eps, void* stream) {
  return x_bf16 ? launch<__nv_bfloat16, SimtF32>(x, gamma, beta, wk, bias, ab,
                                                 ws, out, N, Cin, H, W, Cout,
                                                 CoutP, splits, eps, stream)
                : launch<float, SimtF32>(x, gamma, beta, wk, bias, ab, ws,
                                         out, N, Cin, H, W, Cout, CoutP,
                                         splits, eps, stream);
}

extern "C" int fused_gn_swish_conv_bf16(const void* x, const void* gamma,
                                        const void* beta, const void* wk,
                                        const void* bias, void* ab, void* ws,
                                        void* out, int N, int Cin, int H,
                                        int W, int Cout, int CoutP, int splits,
                                        int x_bf16, float eps, void* stream) {
  return x_bf16 ? launch<__nv_bfloat16, WgmmaBf16>(x, gamma, beta, wk, bias,
                                                   ab, ws, out, N, Cin, H, W,
                                                   Cout, CoutP, splits, eps,
                                                   stream)
                : launch<float, WgmmaBf16>(x, gamma, beta, wk, bias, ab, ws,
                                           out, N, Cin, H, W, Cout, CoutP,
                                           splits, eps, stream);
}
