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
// Two bodies; the wrapper (kernels/conv2d.py::route) picks one from the
// dtypes, C and O alone and passes it in. A block computes a patch of
// output pixels x a range of output channels; the patch is block_h output
// rows x P / block_h columns of one image (P = 128 pixels on wgmma, 64 on
// the FMA tile; block_h is the autotuner's knob, as the TPU kernel's
// block_h is its tile's output rows: 1, 2, 4 or 8, or 0 for the kernel's
// choice, the patch that pads the output plane least, squarer on ties), the
// H and W tails masked at the store.
// - wgmma (bf16 x and w, C % 8 == 0 and O % 8 == 0): gemm_wgmma.cuh's
//   mainloop with the K steps walked as (tap, 64-channel chunk). The A tile
//   of one step is ONE TMA box of x, whose 4-D map runs over (C, W, H, B):
//   box {64, P / block_h, block_h, 1} at (c0, wo + q, ho + p, b) for tap (p,
//   q) lands as 128 pixel rows x 128 bytes, exactly a K-major 128-byte-
//   swizzled A tile. TMA zero-fills channels past C and columns or rows past
//   the image (pixels past Ho or Wo read real or zero data and are masked at
//   the store): no im2col copy and no per-thread gather. B is w viewed as
//   [KH * KW, C, O] in a 3-D MN-major map, boxes of 64 channels x 64 output
//   columns of one tap, zero past C, so a C that is not a multiple of 64
//   needs no special case. The tile is 128 x 256 where O >= 256, so each
//   pixel patch is gathered once for all of O (128 x 128 below). The pixel
//   patch is the grid's fast index.
// - fma (f32, mixed x/w dtypes, or C or O not a multiple of 8): a CUDA-core
//   FMA tile (256 threads of 4 x 4 outputs over 16-deep K steps), templated
//   on x's and w's types, element-wise gathers widened to f32 and the output
//   written in x's type.
// Reuse of the halo between taps inside shared memory and persistent blocks
// are later work.

#include <algorithm>
#include <climits>

#include "attention_common.cuh"
#include "gemm_wgmma.cuh"

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

// ---------------------------------------------------- bf16: the wgmma tile

using repro::kGemmBK;
using repro::kGemmBM;

// gemm_wgmma.cuh's policy for the implicit GEMM: block (x, y) computes the
// 128 pixels of pixel patch x (b, th, tx) for output channels [BN y, BN y +
// BN), over every (tap, 64-channel chunk) K step.
struct ConvTiles {
  CUtensorMap x;  // x [B, H, W, C] as (C, W, H, B): boxes of 64 channels x tw x bh x 1
  CUtensorMap w;  // w [KH * KW, C, O] as (O, C, tap): boxes of 64 columns x 64 channels x 1
  int N;          // O
  int Ho, Wo, KW, bh, tw, tiles_w, tiles_hw, chunks, ksteps;

  __device__ __forceinline__ int k_steps() const { return ksteps; }
  // the patch's image and its first output row and column
  __device__ __forceinline__ void patch(int& b, int& ho, int& wo) const {
    const int tile = blockIdx.x;
    b = tile / tiles_hw;
    const int rem = tile - b * tiles_hw;
    const int th = rem / tiles_w;
    ho = th * bh;
    wo = (rem - th * tiles_w) * tw;
  }
  template <int BN>
  __device__ __forceinline__ void load(int i, uint8_t* sa, uint8_t* sb, uint64_t* bar,
                                       int n0) const {
    int b, ho, wo;
    patch(b, ho, wo);
    const int tap = i / chunks, c0 = (i - tap * chunks) * kGemmBK;
    const int p = tap / KW, q = tap - p * KW;
    repro::tma_load(sa, &x, bar, c0, wo + q, ho + p, b);
#pragma unroll
    for (int j = 0; j < BN / 64; ++j)
      repro::tma_load(sb + j * 64 * 128, &w, bar, n0 + 64 * j, c0, tap);
  }
  // tile row r is pixel (ho + r / tw, wo + r % tw) of the patch
  __device__ __forceinline__ int64_t out_row(int r) const {
    int b, ho, wo;
    patch(b, ho, wo);
    ho += r / tw;
    wo += r % tw;
    if (ho >= Ho || wo >= Wo) return -1;
    return ((static_cast<int64_t>(b) * Ho + ho) * Wo + wo) * N;
  }
  __device__ __forceinline__ int64_t plane() const { return 0; }  // never split
};

template <int BN>
int launch_wgmma_bn(const bf16* x, const bf16* w, bf16* out, int B, int H, int W, int C, int KH,
                    int KW, int O, int bh, cudaStream_t st) {
  ConvTiles t;
  const cuuint64_t x_dims[4] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(W),
                                static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t x_strides[3] = {static_cast<cuuint64_t>(C) * 2,
                                   static_cast<cuuint64_t>(W) * C * 2,
                                   static_cast<cuuint64_t>(H) * W * C * 2};
  const cuuint32_t x_box[4] = {kGemmBK, static_cast<cuuint32_t>(kGemmBM / bh),
                               static_cast<cuuint32_t>(bh), 1};
  const cuuint64_t w_dims[3] = {static_cast<cuuint64_t>(O), static_cast<cuuint64_t>(C),
                                static_cast<cuuint64_t>(KH) * KW};
  const cuuint64_t w_strides[2] = {static_cast<cuuint64_t>(O) * 2,
                                   static_cast<cuuint64_t>(C) * O * 2};
  const cuuint32_t w_box[3] = {64, kGemmBK, 1};
  if (!repro::encode_map(&t.x, x, 4, x_dims, x_strides, x_box) ||
      !repro::encode_map(&t.w, w, 3, w_dims, w_strides, w_box))
    return static_cast<int>(cudaErrorInvalidValue);
  t.N = O;
  t.Ho = H - KH + 1;
  t.Wo = W - KW + 1;
  t.KW = KW;
  t.bh = bh;
  t.tw = kGemmBM / bh;
  t.tiles_w = (t.Wo + t.tw - 1) / t.tw;
  const int64_t tiles_hw = static_cast<int64_t>((t.Ho + bh - 1) / bh) * t.tiles_w;
  const int64_t tiles = B * tiles_hw;
  t.chunks = (C + kGemmBK - 1) / kGemmBK;
  const int64_t ksteps = static_cast<int64_t>(KH) * KW * t.chunks;
  if (tiles > INT_MAX || ksteps > INT_MAX) return -1;
  t.tiles_hw = static_cast<int>(tiles_hw);
  t.ksteps = static_cast<int>(ksteps);
  const dim3 grid(static_cast<unsigned>(tiles), (O + BN - 1) / BN);
  if (grid.y > 65535) return -1;
  return repro::launch_gemm_wgmma<BN>(t, grid, out, nullptr, st);
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

// block_h 0: of the patches of `pixels` (64 or 128) as 8, 4, 2 or 1 rows,
// the one whose tiles pad the output plane least, the squarer on ties (its
// input rows overlap most between taps).
int pick_block_h(int Ho, int Wo, int pixels) {
  int best = 8;
  int64_t least = INT64_MAX;
  for (int bh = 8; bh >= 1; bh /= 2) {
    const int tw = pixels / bh;
    const int64_t padded =
        static_cast<int64_t>((Ho + bh - 1) / bh * bh) * ((Wo + tw - 1) / tw * tw);
    if (padded < least) {
      least = padded;
      best = bh;
    }
  }
  return best;
}

// The bodies, as kernels/conv2d.py::route names them.
enum Route { kWgmma = 0, kFma = 1 };

template <typename TX, typename TW>
int launch(int route, const void* x, const void* w, void* out, int B, int H, int W, int C, int KH,
           int KW, int O, int block_h, cudaStream_t st) {
  const int Ho = H - KH + 1, Wo = W - KW + 1;
  const int64_t K = static_cast<int64_t>(KH) * KW * C;
  if (Ho < 1 || Wo < 1 || C < 1 || O < 1 || K > INT_MAX) return -1;
  if (block_h != 0 && block_h != 1 && block_h != 2 && block_h != 4 && block_h != 8) return -1;
  if (route == kWgmma) {
    if constexpr (std::is_same_v<TX, bf16> && std::is_same_v<TW, bf16>) {
      if (C % 8 || O % 8) return -1;
      const int bh = block_h != 0 ? block_h : pick_block_h(Ho, Wo, kGemmBM);
      const bf16* xb = static_cast<const bf16*>(x);
      const bf16* wb = static_cast<const bf16*>(w);
      bf16* ob = static_cast<bf16*>(out);
      return O >= 256 ? launch_wgmma_bn<256>(xb, wb, ob, B, H, W, C, KH, KW, O, bh, st)
                      : launch_wgmma_bn<128>(xb, wb, ob, B, H, W, C, KH, KW, O, bh, st);
    }
    return -1;
  }
  if (route != kFma) return -1;
  Geom g;
  g.H = H; g.W = W; g.C = C; g.KW = KW; g.O = O;
  g.Ho = Ho;
  g.Wo = Wo;
  g.K = static_cast<int>(K);
  g.bh = block_h != 0 ? block_h : pick_block_h(g.Ho, g.Wo, kBM);
  g.tw = kBM / g.bh;
  g.tiles_w = (g.Wo + g.tw - 1) / g.tw;
  const int64_t tiles_hw = static_cast<int64_t>((g.Ho + g.bh - 1) / g.bh) * g.tiles_w;
  g.o_tiles = (O + kBN - 1) / kBN;
  const int64_t blocks = B * tiles_hw * g.o_tiles;
  if (blocks > INT_MAX) return -1;
  g.tiles_hw = static_cast<int>(tiles_hw);
  if (blocks == 0) return 0;
  conv_fma_kernel<TX, TW><<<static_cast<unsigned>(blocks), kFmaThreads, 0, st>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w), static_cast<TX*>(out), g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [B, H, W, C], w [KH, KW, C, O], out [B, H - KH + 1, W - KW + 1, O], all
// contiguous; x and out of xdtype, w of wdtype (0 = float32, 1 = bfloat16).
// route: the body (Route; kernels/conv2d.py::ROUTES), wgmma for bf16 x and
// w with C and O multiples of 8 (x, w and out 16-byte aligned), fma for any
// types and shape. block_h: output rows of a block's pixel patch, 1, 2, 4 or
// 8, or 0 for the kernel's choice. Returns cudaGetLastError() after the
// launch, -1 for a route, block_h or shape the kernel does not take, -2 for
// an unsupported dtype.
extern "C" int repro_conv2d(const void* x, const void* w, void* out, int B, int H, int W, int C,
                            int KH, int KW, int O, int block_h, int xdtype, int wdtype, int route,
                            void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_CONV(XC, TX, WC, TW) \
  if (xdtype == XC && wdtype == WC) \
    return launch<TX, TW>(route, x, w, out, B, H, W, C, KH, KW, O, block_h, st);
  REPRO_CONV(repro::kF32, float, repro::kF32, float)
  REPRO_CONV(repro::kBF16, bf16, repro::kBF16, bf16)
  REPRO_CONV(repro::kBF16, bf16, repro::kF32, float)
  REPRO_CONV(repro::kF32, float, repro::kBF16, bf16)
#undef REPRO_CONV
  return -2;
}
