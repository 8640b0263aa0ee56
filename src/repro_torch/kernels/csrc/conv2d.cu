// 2-D convolution, NHWC x HWIO, VALID, stride 1, as an implicit GEMM (the
// paper's fconv2d).
//
// Replaces the TPU kernel repro/kernels/conv2d.py::conv2d (_conv2d_kernel):
// x [B, H, W, C] and w [KH, KW, C, O], each f32 or bf16 (x and w may
// differ, as the TPU kernel widens both to f32); out [B, H - KH + 1, W - KW
// + 1, O] in x's type, out[b, i, j, o] = sum over (p, q, c) of x[b, i + p,
// j + q, c] * w[p, q, c, o], summed in f32. The TPU kernel
// sums KH * KW products [rows * W_out, C] @ [C, O] per tile; this kernel is
// the same sum as one product [M, K] @ [K, N] with M = B * H_out * W_out
// output pixels, N = O and K = KH * KW * C, whose A tile is gathered from x
// on the fly (pixel m's row at column k = (p * KW + q) * C + c is C
// contiguous channels of x at (i + p, j + q)), and whose B is w itself
// viewed as [K, O] (HWIO's own layout). No im2col copy is made.
//
// What bounds it on the H100: the operations, 2 M N K (1.23 TFLOP at B = 4,
// H = W = 512, C = O = 256, 3 x 3 taps: 1.24 ms at 989 TFLOP/s bf16).
//
// Simple design, matmul.cu's two tiles with the A loader replaced by the
// pixel gather. A block computes 64 output pixels x 64 output channels; its
// 64 pixels are a patch of block_h output rows x 64 / block_h columns of one
// image (the autotuner's knob, as the TPU kernel's block_h is its tile's
// output rows: 1, 2, 4 or 8, or 0 for the kernel's choice, the patch that
// pads the output plane least, squarer on ties), the H and W tails masked.
// The pixel tile is the slow index of the 1-D grid, so a tile's O tiles run
// side by side and read its input rows from L2.
// - bf16 with C % 8 == 0 and O % 8 == 0: four warps of 32 x 32 outputs on
//   mma.sync m16n8k16 (bf16 in, f32 accumulate), A and B tiles of 32-deep K
//   steps streamed through a 4-stage cp.async ring (16-byte chunks of 8
//   channels never straddle a tap; chunks past an edge are zero-filled).
// - f32, bf16 with other C or O, or x and w of different types: a
//   CUDA-core FMA tile (256 threads of 4 x 4 outputs over 16-deep K steps),
//   templated on x's and w's types, element-wise gathers widened to f32 and
//   the output written in x's type.
// wgmma, TMA and reuse of the halo in shared memory are later work.

#include <algorithm>
#include <climits>

#include "attention_common.cuh"
#include "mma_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 64, kBN = 64;  // output pixels x output channels of a block

// The implicit GEMM's geometry.
struct Geom {
  int H, W, C, KW, O, Ho, Wo, K;  // K = KH * KW * C
  int bh, tw;                     // a pixel tile: bh output rows x tw = 64 / bh columns
  int tiles_w, tiles_hw, o_tiles;
};

// Output pixel r (0 .. 63) of pixel tile `tile`: its offsets in x (tap (0,
// 0), channel 0) and in out (channel 0); false past the H or W edge.
__device__ __forceinline__ bool pixel(const Geom& g, int tile, int r, int64_t& in_off,
                                      int64_t& out_off) {
  const int b = tile / g.tiles_hw, rem = tile - b * g.tiles_hw;
  const int th = rem / g.tiles_w, tx = rem - th * g.tiles_w;
  const int ho = th * g.bh + r / g.tw, wo = tx * g.tw + r % g.tw;
  in_off = ((static_cast<int64_t>(b) * g.H + ho) * g.W + wo) * g.C;
  out_off = ((static_cast<int64_t>(b) * g.Ho + ho) * g.Wo + wo) * g.O;
  return ho < g.Ho && wo < g.Wo;
}

// The offset in x of GEMM column k (tap (p, q), channel c) from its pixel's.
__device__ __forceinline__ int64_t tap_offset(const Geom& g, int k) {
  const int tap = k / g.C, c = k - tap * g.C;
  const int p = tap / g.KW, q = tap - p * g.KW;
  return (static_cast<int64_t>(p) * g.W + q) * g.C + c;
}

// ------------------------------------------------ bf16 tensor-core tile

constexpr int kMmaBK = 32;
constexpr int kMmaThreads = 128;
constexpr int kPad = 8;     // bf16 elements of row padding (conflict-free fragment reads)
constexpr int kStages = 4;  // cp.async ring depth

__global__ void __launch_bounds__(kMmaThreads)
conv_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w, bf16* __restrict__ out,
                Geom g) {
  __shared__ __align__(16) uint16_t sa[kStages][kBM][kMmaBK + kPad];  // [pixel][k]
  __shared__ __align__(16) uint16_t sb[kStages][kMmaBK][kBN + kPad];  // [k][channel]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t4 = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int tile = blockIdx.x / g.o_tiles;
  const int n0 = (blockIdx.x - tile * g.o_tiles) * kBN;
  const int ksteps = (g.K + kMmaBK - 1) / kMmaBK;

  // this thread's A chunks: pixels tid / 4 and tid / 4 + 32, channels kc .. kc + 7 of a K step
  const int kc = (tid & 3) * 8;
  int64_t a_off[2], unused;
  bool a_ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) a_ok[h] = pixel(g, tile, tid / 4 + 32 * h, a_off[h], unused);

  auto load_stage = [&](int stage, int k0) {
    const int k = k0 + kc;
    const int64_t t = k < g.K ? tap_offset(g, k) : 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool ok = a_ok[h] && k < g.K;
      repro::cp_async16(&sa[stage][tid / 4 + 32 * h][kc], ok ? x + a_off[h] + t : x, ok);
    }
#pragma unroll
    for (int i = tid; i < kMmaBK * kBN / 8; i += kMmaThreads) {
      const int r = i / (kBN / 8), nc = (i % (kBN / 8)) * 8;
      const bool ok = k0 + r < g.K && n0 + nc < g.O;
      repro::cp_async16(&sb[stage][r][nc],
                        ok ? w + static_cast<int64_t>(k0 + r) * g.O + n0 + nc : w, ok);
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ksteps) load_stage(s, s * kMmaBK);
    repro::cp_async_commit();
  }
  for (int ks = 0; ks < ksteps; ++ks) {
    repro::cp_async_wait<kStages - 2>();  // step ks has landed (this thread's copies)
    __syncthreads();                      // ... and everyone's; step ks - 1's stage is free
    const int next = ks + kStages - 1;
    if (next < ksteps) load_stage(next % kStages, next * kMmaBK);
    repro::cp_async_commit();
    const int st = ks % kStages;
#pragma unroll
    for (int kk = 0; kk < kMmaBK; kk += 16) {
      uint32_t af[2][4], bfr[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {  // rows gq / gq + 8, columns 2 t4 (+ 8)
        const int r = wm + mt * 16 + gq;
        af[mt][0] = *reinterpret_cast<const uint32_t*>(&sa[st][r][kk + t4 * 2]);
        af[mt][1] = *reinterpret_cast<const uint32_t*>(&sa[st][r + 8][kk + t4 * 2]);
        af[mt][2] = *reinterpret_cast<const uint32_t*>(&sa[st][r][kk + t4 * 2 + 8]);
        af[mt][3] = *reinterpret_cast<const uint32_t*>(&sa[st][r + 8][kk + t4 * 2 + 8]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {  // rows k and k + 1 (and + 8) of channel col
        const int col = wn + nt * 8 + gq, k = kk + t4 * 2;
        bfr[nt][0] = static_cast<uint32_t>(sb[st][k][col]) |
                     (static_cast<uint32_t>(sb[st][k + 1][col]) << 16);
        bfr[nt][1] = static_cast<uint32_t>(sb[st][k + 8][col]) |
                     (static_cast<uint32_t>(sb[st][k + 9][col]) << 16);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) repro::mma_16816(acc[mt][nt], af[mt], bfr[nt]);
    }
  }
  repro::cp_async_wait<0>();

  // accumulator (mt, nt): [0..1] at row gq, [2..3] at row gq + 8, channels 2 t4 + {0, 1}
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int64_t in_unused, o_off;
      if (!pixel(g, tile, wm + mt * 16 + gq + 8 * h, in_unused, o_off)) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = n0 + wn + nt * 8 + t4 * 2;
        if (col >= g.O) continue;  // O % 8 == 0: col + 1 is inside too
        *reinterpret_cast<__nv_bfloat162*>(out + o_off + col) =
            __floats2bfloat162_rn(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
      }
    }
  }
}

// ------------------------------------------------ CUDA-core FMA tile

constexpr int kFmaBK = 16;
constexpr int kFmaThreads = 256;

template <typename TX, typename TW>
__global__ void __launch_bounds__(kFmaThreads)
conv_fma_kernel(const TX* __restrict__ x, const TW* __restrict__ w, TX* __restrict__ out,
                Geom g) {
  __shared__ __align__(16) float sa[kFmaBK][kBM + 4];  // A transposed: [k][pixel]
  __shared__ __align__(16) float sb[kFmaBK][kBN + 4];  // [k][channel]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int tile = blockIdx.x / g.o_tiles;
  const int n0 = (blockIdx.x - tile * g.o_tiles) * kBN;
  const int ar = tid / 4, akc = (tid % 4) * 4;    // A: pixel ar, 4 consecutive k
  const int br = tid / 16, bnc = (tid % 16) * 4;  // B: k row br, 4 consecutive channels
  int64_t a_off, unused;
  const bool a_ok = pixel(g, tile, ar, a_off, unused);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < g.K; k0 += kFmaBK) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = k0 + akc + e;
      sa[akc + e][ar] = a_ok && k < g.K ? repro::to_f32(x[a_off + tap_offset(g, k)]) : 0.f;
      const int kb = k0 + br, col = n0 + bnc + e;
      sb[br][bnc + e] =
          kb < g.K && col < g.O ? repro::to_f32(w[static_cast<int64_t>(kb) * g.O + col]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kFmaBK; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&sa[k][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&sb[k][tx * 4]);
      const float a4[4] = {av.x, av.y, av.z, av.w};
      const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a4[i], b4[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int64_t in_unused, o_off;
    if (!pixel(g, tile, ty * 4 + i, in_unused, o_off)) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < g.O) repro::store_f32(out + o_off + col, acc[i][j]);
    }
  }
}

// block_h 0: of the patches 8 x 8, 4 x 16, 2 x 32 and 1 x 64, the one whose
// tiles pad the output plane least, the squarer on ties (its input rows
// overlap most between taps).
int pick_block_h(int Ho, int Wo) {
  int best = 8;
  int64_t least = INT64_MAX;
  for (int bh = 8; bh >= 1; bh /= 2) {
    const int tw = kBM / bh;
    const int64_t padded =
        static_cast<int64_t>((Ho + bh - 1) / bh * bh) * ((Wo + tw - 1) / tw * tw);
    if (padded < least) {
      least = padded;
      best = bh;
    }
  }
  return best;
}

template <typename TX, typename TW>
int launch(const void* x, const void* w, void* out, int B, int H, int W, int C, int KH, int KW,
           int O, int block_h, cudaStream_t st) {
  Geom g;
  g.H = H; g.W = W; g.C = C; g.KW = KW; g.O = O;
  g.Ho = H - KH + 1;
  g.Wo = W - KW + 1;
  const int64_t K = static_cast<int64_t>(KH) * KW * C;
  if (g.Ho < 1 || g.Wo < 1 || C < 1 || O < 1 || K > INT_MAX) return -1;
  g.K = static_cast<int>(K);
  g.bh = block_h != 0 ? block_h : pick_block_h(g.Ho, g.Wo);
  if (g.bh != 1 && g.bh != 2 && g.bh != 4 && g.bh != 8) return -1;
  g.tw = kBM / g.bh;
  g.tiles_w = (g.Wo + g.tw - 1) / g.tw;
  const int64_t tiles_hw = static_cast<int64_t>((g.Ho + g.bh - 1) / g.bh) * g.tiles_w;
  g.o_tiles = (O + kBN - 1) / kBN;
  const int64_t blocks = B * tiles_hw * g.o_tiles;
  if (blocks > INT_MAX) return -1;
  g.tiles_hw = static_cast<int>(tiles_hw);
  if (blocks == 0) return 0;
  const dim3 grid(static_cast<unsigned>(blocks));
  if constexpr (std::is_same_v<TX, bf16> && std::is_same_v<TW, bf16>) {
    if (C % 8 == 0 && O % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
        reinterpret_cast<uintptr_t>(w) % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 4 == 0) {
      conv_mma_kernel<<<grid, kMmaThreads, 0, st>>>(static_cast<const bf16*>(x),
                                                    static_cast<const bf16*>(w),
                                                    static_cast<bf16*>(out), g);
      return static_cast<int>(cudaGetLastError());
    }
  }
  conv_fma_kernel<TX, TW><<<grid, kFmaThreads, 0, st>>>(static_cast<const TX*>(x),
                                                        static_cast<const TW*>(w),
                                                        static_cast<TX*>(out), g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [B, H, W, C], w [KH, KW, C, O], out [B, H - KH + 1, W - KW + 1, O], all
// contiguous; x and out of xdtype, w of wdtype (0 = float32, 1 = bfloat16).
// block_h: output rows of a block's pixel patch, 1, 2, 4 or 8, or 0 for the
// kernel's choice. Returns cudaGetLastError() after the launch, -1 for a
// block_h or a shape the kernel does not take, -2 for an unsupported dtype.
extern "C" int repro_conv2d(const void* x, const void* w, void* out, int B, int H, int W, int C,
                            int KH, int KW, int O, int block_h, int xdtype, int wdtype,
                            void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_CONV(XC, TX, WC, TW) \
  if (xdtype == XC && wdtype == WC) \
    return launch<TX, TW>(x, w, out, B, H, W, C, KH, KW, O, block_h, st);
  REPRO_CONV(repro::kF32, float, repro::kF32, float)
  REPRO_CONV(repro::kBF16, bf16, repro::kBF16, bf16)
  REPRO_CONV(repro::kBF16, bf16, repro::kF32, float)
  REPRO_CONV(repro::kF32, float, repro::kBF16, bf16)
#undef REPRO_CONV
  return -2;
}
