// Matrix product [M, K] @ [K, N] with f32 accumulation, and its int8-weight
// form with one f32 scale per output column.
//
// Replaces the TPU kernels repro/kernels/matmul.py::matmul_q8
// (_matmul_q8_kernel) and ::matmul (_matmul_kernel): a [M, K] row-major
// (f32 or bf16), b [K, N] row-major (int8 with scale [N] f32 for matmul_q8;
// the type of a for matmul), out [M, N] in a's type. out[m, n] =
// (sum_k a[m, k] * b[k, n]) * scale[n]: the sum in f32, the column scale
// applied once to the finished sum (the TPU kernel's flush multiply), the K,
// M and N tails masked.
//
// What bounds it on the H100: at the serving path's decode shapes (M = 4-64
// live tokens, K and N of 4096 or 13440) the weight bytes, K * N of them for
// int8 (0.0165 ms at M = 4, K = 4096, N = 13440 at 3.35 TB/s), so the int8
// tile must be the only weight traffic and is widened on chip; at
// M >= ~300 (bf16) the 2 * M * K * N flops, which only tensor cores deliver.
//
// Seven bodies; the wrapper (kernels/matmul.py::route) picks one from M, K,
// N and the operand types alone and passes it in:
// - gemv_tc (M <= 8, bf16 activations, bf16 or int8 weights, K % 16 == 0
//   and N % 16 == 0: decode at up to 8 slots): the tensor-core GEMV. The
//   weight panel streams through a 5-stage cp.async ring in shared memory
//   (32 KB of weights in flight a block, K split so that two blocks or
//   fewer share an SM), the weights' stored layout ([K, N] row-major) kept;
//   the fragments come from ldmatrix .trans and the products go to mma.sync
//   m16n8k16 as out^T = b^T a^T, the int8 weight widened to bf16 exactly on
//   the way (three integer ops and one bf16x2 fma a pair); split-K partials
//   added in slice order by the last block of a strip (details at
//   gemv_tc_kernel).
// - gemv_tc_rows (8 < M <= 64, bf16 activations, int8 weights, K % 16 == 0
//   and N % 16 == 0: decode at 9-64 slots, packs and admissions within the
//   prefill budget): the same kernel staging 16, 32 or 64 token rows, each
//   widened weight fragment feeding one mma per 8 tokens.
// - gemv (M <= 8, f32 activations or K/N tails): a split-K GEMV on CUDA
//   cores. Block (x, y) owns a strip of 128 columns and a slice of the K
//   rows, sliced so that the blocks fill whole waves of two per SM; its
//   slice of the M activation
//   rows is staged once in shared memory as f32 (32 KB). Each warp reads
//   whole 128-column row segments (lane i: 4 columns, one vector load,
//   neighbouring lanes on neighbouring addresses) of every 8th 4-row quad;
//   per step a thread widens 32 weight rows held as raw bits in registers
//   (int8 by a byte permute into an f32 mantissa and one subtraction, no
//   int-to-float conversion) and accumulates [MR, 4] in f32 registers while
//   the next step's loads are in flight (two register buffers). No barrier
//   inside the K loop; the warps' partials meet in shared memory, and the
//   last block of a strip to finish (an atomic ticket) adds the slices'
//   partials in slice order, so the sum does not depend on timing. MR is M
//   rounded up to 4 or 8.
// - wgmma (M > 8, bf16 @ bf16 unscaled, K % 8 == 0 and N % 8 == 0, TMA's
//   16-byte strides): gemm_wgmma.cuh's warp-specialised mainloop, 128 x 256
//   or 128 x 128 tiles (block_n) on wgmma m64nBNk16, A [M, K] as K-major
//   2-D TMA boxes of 128 rows x 64, B [K, N] as MN-major boxes of 64 k-rows
//   x 64 columns (the way flash attention reads V), zero-filled past every
//   edge. The grid runs the M tiles of one B panel side by side, so they
//   share it through L2. K splits write f32 partials that
//   split_reduce_kernel adds in split order.
// - mma_pipe (bf16 @ int8 scaled, K % 8 == 0 and N % 16 == 0, at M > 64 or
//   where gemv_tc_rows does not take K): 64 x 64 output tiles, four warps
//   of 32 x 32 on mma.sync m16n8k16 (bf16 in, f32 accumulate); the A and B
//   tiles of 32-deep K steps stream through a
//   4-stage cp.async ring in shared memory (zero-filled past the edges) and
//   the raw int8 weight is widened to bf16 as the B fragments are built
//   (exact: every int8 is a bf16); K is split across blocks where that
//   fills the card's waves better, and split_reduce_kernel adds the f32
//   partials in a fixed order.
// - mma_tile (M > 8, bf16 activations, other K or N): the same mma.sync
//   tile staged synchronously, widened to bf16 on the way.
// - fma (M > 8, f32 activations, the small parity model): a CUDA-core FMA
//   tile (256 threads of 4 x 4 outputs over 16-deep K steps), so f32 stays
//   f32 (wgmma would read it as TF32).
// The K splits (split_k: 0, the default, is the kernel's choice; 1, 2, 4 or
// 8 force it) and the wgmma tile (block_m x block_n: 0 x 0, the kernel's
// choice, 128 x 128 or 128 x 256) are the autotuner's knobs.

#include <algorithm>

#include "attention_common.cuh"
#include "gemm_wgmma.cuh"
#include "mma_common.cuh"

namespace repro {

__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

}  // namespace repro

namespace {

using bf16 = __nv_bfloat16;

// Four consecutive elements (row, col..col+3) of a row-major [rows, cols]
// matrix widened to f32; elements past either edge read as 0. One vector
// load when the four are inside the matrix and aligned (cols % 4 == 0, the
// base 16-byte aligned), else element by element.
template <typename T>
__device__ __forceinline__ void load4(const T* __restrict__ p, int row, int col, int rows,
                                      int cols, float (&v)[4]) {
  const int64_t off = static_cast<int64_t>(row) * cols + col;
  if (row < rows && col + 3 < cols && (cols & 3) == 0) {
    repro::load_vec<4>(p + off, v);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      v[i] = (row < rows && col + i < cols) ? repro::to_f32(p[off + i]) : 0.f;
  }
}

// The same four elements as raw bits (widened later, so a load in flight
// holds one register per 4 bytes).
template <typename T>
struct Raw4;
template <>
struct Raw4<int8_t> {
  uint32_t v;
};
template <>
struct Raw4<bf16> {
  uint2 v;
};
template <>
struct Raw4<float> {
  float4 v;
};

// The first n (0..4) of four elements at p as raw bits, zeros after them.
__device__ __forceinline__ void masked_raw(const int8_t* p, int n, uint32_t& v) {
  v = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (i < n) v |= static_cast<uint32_t>(static_cast<uint8_t>(p[i])) << (8 * i);
}
__device__ __forceinline__ void masked_raw(const bf16* p, int n, uint2& v) {
  uint32_t e[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) e[i] = i < n ? __bfloat16_as_ushort(p[i]) : 0u;
  v = make_uint2(e[0] | (e[1] << 16), e[2] | (e[3] << 16));
}
__device__ __forceinline__ void masked_raw(const float* p, int n, float4& v) {
  v = make_float4(n > 0 ? p[0] : 0.f, n > 1 ? p[1] : 0.f, n > 2 ? p[2] : 0.f,
                  n > 3 ? p[3] : 0.f);
}

template <typename T>
__device__ __forceinline__ Raw4<T> load_raw4(const T* __restrict__ p, int row, int col,
                                             int rows, int cols) {
  Raw4<T> r;
  const T* q = p + static_cast<int64_t>(row) * cols + col;
  if (row < rows && col + 3 < cols && (cols & 3) == 0) {
    r.v = *reinterpret_cast<const decltype(r.v)*>(q);
  } else {
    masked_raw(q, row < rows ? min(cols - col, 4) : 0, r.v);
  }
  return r;
}

// A raw int8 byte (zero-extended) as f32: 2^23 + (b + 128) built in the
// mantissa, minus 2^23 + 128. Exact.
__device__ __forceinline__ float i8_bits_to_f32(uint32_t byte) {
  return __int_as_float(0x4B000000 | (byte ^ 0x80u)) - 8388736.f;
}

__device__ __forceinline__ void widen(const Raw4<int8_t>& r, float (&o)[4]) {
  const uint32_t u = r.v ^ 0x80808080u;  // every byte b + 128
#pragma unroll
  for (int i = 0; i < 4; ++i)  // byte i into the mantissa of 2^23 (one byte permute)
    o[i] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + i)) - 8388736.f;
}

__device__ __forceinline__ void widen(const Raw4<bf16>& r, float (&o)[4]) {
  o[0] = __uint_as_float(r.v.x << 16);
  o[1] = __uint_as_float(r.v.x & 0xFFFF0000u);
  o[2] = __uint_as_float(r.v.y << 16);
  o[3] = __uint_as_float(r.v.y & 0xFFFF0000u);
}

__device__ __forceinline__ void widen(const Raw4<float>& r, float (&o)[4]) {
  o[0] = r.v.x; o[1] = r.v.y; o[2] = r.v.z; o[3] = r.v.w;
}

// bf16x2 of two f32 integers of at most 8 significant bits (int8 values):
// their upper halves, exactly.
__device__ __forceinline__ uint32_t pack_int_bf16x2(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(hi))) << 16);
}

// ------------------------------------------------------------------ GEMV

constexpr int kGemvThreads = 256;
constexpr int kGemvColThreads = 32;                         // a warp: one row, 4 columns a lane
constexpr int kGemvCols = kGemvColThreads * 4;              // 128 columns per block
constexpr int kGemvGroups = kGemvThreads / kGemvColThreads;  // 8 K groups (warps)
constexpr int kGemvMaxM = 8;         // larger M: the tiles
constexpr int kGemvQuantum = 4 * kGemvGroups;  // K rows a slice is a multiple of
constexpr int kGemvSmem = 8192;      // f32 of shared memory: the A slice, then the reduce

// Most K rows of one block: its [MR, slice] f32 slice of A fills kGemvSmem.
__host__ __device__ constexpr int gemv_max_slice(int mr) { return kGemvSmem / mr; }

// Block (x, y) computes columns [128 x, 128 x + 128) over the K slice
// [y * slice, (y + 1) * slice). With gridDim.y = S > 1 each block stores its
// f32 partial to ws[y] ([M, N]), and the last block of a column strip to
// finish (a ticket in counters[x], reset by that block) adds the S partials
// in slice order, scales and stores.
template <typename TA, typename TB, bool kScaled, int MR>
__global__ void __launch_bounds__(kGemvThreads, 2)
gemv_kernel(const TA* __restrict__ a, const TB* __restrict__ b, const float* __restrict__ scale,
            TA* __restrict__ out, float* __restrict__ ws, int* __restrict__ counters, int M,
            int K, int N, int slice) {
  // 4-row quads per step: 32 weight rows of int8, 16 of bf16, 8 of f32 — 128
  // bytes per thread per step, double-buffered in two sets of raw-bit registers
  constexpr int U = 8 / static_cast<int>(sizeof(TB));
  constexpr int kStep = kGemvGroups * U;  // quads per step of the block
  constexpr int kSlice = gemv_max_slice(MR);
  constexpr int kRedM = MR < 8 ? MR : 8;  // rows of M reduced per round
  __shared__ __align__(16) float smem[kGemvSmem];
  __shared__ int last;
  float (*sa)[kSlice] = reinterpret_cast<float (*)[kSlice]>(smem);  // [MR][kSlice]
  float (*red)[kRedM][kGemvCols] =
      reinterpret_cast<float (*)[kRedM][kGemvCols]>(smem);  // [warps][kRedM][cols]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = blockIdx.x * kGemvCols + lane * 4;
  const int kbeg = blockIdx.y * slice, kend = min(K, kbeg + slice);

  float acc[MR][4];
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[m][i] = 0.f;

  // warp kg reads the quads q = kg + 8 j of the slice: rows kbeg + 4q ..
  // kbeg + 4q + 3, a whole row segment of the strip per load (rows past the
  // slice read as 0, unloaded)
  Raw4<TB> w0[U][4], w1[U][4];
  auto load_step = [&](Raw4<TB>(&w)[U][4], int q0) {
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        w[u][r] = load_raw4(b, kbeg + 4 * (q0 + kGemvGroups * u) + r, n, kend, N);
  };
  auto compute_step = [&](const Raw4<TB>(&w)[U][4], int q0) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int kk = 4 * (q0 + kGemvGroups * u);
      if (kk >= slice) break;
      float wf[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) widen(w[u][r], wf[r]);
#pragma unroll
      for (int m = 0; m < MR; ++m) {
        const float4 av = *reinterpret_cast<const float4*>(&sa[m][kk]);  // broadcast
        const float ar[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[m][i] = fmaf(ar[r], wf[r][i], acc[m][i]);
      }
    }
  };
  // the first step's weight loads are in flight while the slice of A is staged
  load_step(w0, warp);
  {  // the slice of A as f32, 4 consecutive k per chunk, every load issued first
    constexpr int kChunks = MR * kSlice / 4 / kGemvThreads;
    float v[kChunks][4];
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const int i = threadIdx.x + j * kGemvThreads;
      const int m = i / (kSlice / 4), k = kbeg + (i % (kSlice / 4)) * 4;
      const TA* p = a + static_cast<int64_t>(m) * K + k;
      if (m < M && k + 3 < kend && (K & 3) == 0) {
        repro::load_vec<4>(p, v[j]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) v[j][e] = (m < M && k + e < kend) ? repro::to_f32(p[e]) : 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const int i = threadIdx.x + j * kGemvThreads;
      *reinterpret_cast<float4*>(&sa[i / (kSlice / 4)][(i % (kSlice / 4)) * 4]) =
          make_float4(v[j][0], v[j][1], v[j][2], v[j][3]);
    }
  }
  __syncthreads();
  // two steps per turn, so each buffer is a fixed set of registers: the next
  // step's loads are issued before the current step is computed
  for (int q0 = warp; kbeg + 4 * q0 < kend; q0 += 2 * kStep) {
    const int q1 = q0 + kStep;
    if (kbeg + 4 * q1 < kend) load_step(w1, q1);
    compute_step(w0, q0);
    if (kbeg + 4 * q1 >= kend) break;
    if (kbeg + 4 * (q1 + kStep) < kend) load_step(w0, q1 + kStep);
    compute_step(w1, q1);
  }

  // the warps' partials, kRedM rows of M at a time, through shared memory
  // (which held the slice of A until this barrier)
  const int splits = gridDim.y;
#pragma unroll
  for (int m0 = 0; m0 < MR; m0 += kRedM) {
    __syncthreads();
#pragma unroll
    for (int m = 0; m < kRedM; ++m)
#pragma unroll
      for (int i = 0; i < 4; ++i) red[warp][m][lane * 4 + i] = acc[m0 + m][i];
    __syncthreads();
    for (int idx = threadIdx.x; idx < kRedM * kGemvCols; idx += kGemvThreads) {
      const int m = m0 + idx / kGemvCols, col = blockIdx.x * kGemvCols + idx % kGemvCols;
      if (m >= M || col >= N) continue;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kGemvGroups; ++w) s += red[w][idx / kGemvCols][idx % kGemvCols];
      if (splits > 1) {
        ws[(static_cast<int64_t>(blockIdx.y) * M + m) * N + col] = s;
        continue;
      }
      if constexpr (kScaled) s *= scale[col];
      repro::store_f32(out + static_cast<int64_t>(m) * N + col, s);
    }
  }
  if (splits == 1) return;
  __threadfence();  // this block's partial is visible before its ticket
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&counters[blockIdx.x], 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int idx = threadIdx.x; idx < MR * kGemvCols; idx += kGemvThreads) {
    const int m = idx / kGemvCols, col = blockIdx.x * kGemvCols + idx % kGemvCols;
    if (m >= M || col >= N) continue;
    float s = 0.f;
    for (int z = 0; z < splits; ++z)
      s += __ldcg(ws + (static_cast<int64_t>(z) * M + m) * N + col);
    if constexpr (kScaled) s *= scale[col];
    repro::store_f32(out + static_cast<int64_t>(m) * N + col, s);
  }
  if (threadIdx.x == 0) counters[blockIdx.x] = 0;  // ready for the next launch
}

int device_sms() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  return sms;
}

// K rows per GEMV block: at most the A slice shared memory holds for MR
// rows, a multiple of kGemvQuantum, and as many K splits (from the fewest
// allowed, up to 16 more) as fill the waves of two blocks per SM best: the
// blocks are of equal work, so a last wave that is mostly empty costs as
// much as a full one. Fewer splits win ties within 2%. A forced split_k > 0
// asks for that many slices instead (at least the fewest allowed).
int gemv_slice(int M, int K, int N, int split_k) {
  const int most = gemv_max_slice(M <= 4 ? 4 : 8);
  if (split_k > 0) {
    const int rows = ((K + split_k - 1) / split_k + kGemvQuantum - 1) / kGemvQuantum;
    return std::min(most, std::max(1, rows) * kGemvQuantum);
  }
  const int strips = (N + kGemvCols - 1) / kGemvCols;
  const int slots = 2 * device_sms();
  const int fewest = (K + most - 1) / most;
  int best = most;
  double best_fill = -1.0;
  for (int want = fewest; want <= fewest + 16; ++want) {
    const int rows = std::max(
        kGemvQuantum, ((K + want - 1) / want + kGemvQuantum - 1) / kGemvQuantum * kGemvQuantum);
    const int blocks = strips * ((K + rows - 1) / rows);
    const double fill = static_cast<double>(blocks) / (((blocks + slots - 1) / slots) * slots);
    if (fill > best_fill + 0.02) {
      best_fill = fill;
      best = rows;
    }
  }
  return best;
}

// -------------------------------------------------- tiles, M > 8

constexpr int kBM = 64, kBN = 64;

// bf16 activations: mma.sync m16n8k16, four warps of 32 x 32 outputs.
constexpr int kMmaBK = 32;
constexpr int kMmaThreads = 128;
constexpr int kPad = 8;      // bf16 elements of A row padding (conflict-free fragment reads)
constexpr int kStages = 4;   // cp.async ring depth

using repro::cp_async16;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::i8_bf16x2;
using repro::ldsm_x2;
using repro::ldsm_x4;
using repro::ldsm_x4_trans;
using repro::mma_16816;

// The A fragments of the warp's two m16 tiles at k offset kk of a staged
// [kBM][kMmaBK + kPad] bf16 tile (row g / g + 8, columns 2 * t4 (+ 8)).
__device__ __forceinline__ void a_fragments(uint16_t (*sa)[kMmaBK + kPad], int wm, int g,
                                            int t4, int kk, uint32_t (&af)[2][4]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int r = wm + mt * 16 + g;
    af[mt][0] = *reinterpret_cast<const uint32_t*>(&sa[r][kk + t4 * 2]);
    af[mt][1] = *reinterpret_cast<const uint32_t*>(&sa[r + 8][kk + t4 * 2]);
    af[mt][2] = *reinterpret_cast<const uint32_t*>(&sa[r][kk + t4 * 2 + 8]);
    af[mt][3] = *reinterpret_cast<const uint32_t*>(&sa[r + 8][kk + t4 * 2 + 8]);
  }
}

// accumulator (mt, nt) of a warp: [0..1] at row g, [2..3] at row g + 8,
// columns 2 * t4 + {0, 1}; times the column scale, cast to bf16.
template <bool kScaled>
__device__ __forceinline__ void store_tile(const float (&acc)[2][4][4], const float* scale,
                                           bf16* out, int row0, int col0, int g, int t4, int M,
                                           int N) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = row0 + mt * 16 + g + (i >> 1) * 8;
        const int col = col0 + nt * 8 + t4 * 2 + (i & 1);
        if (row >= M || col >= N) continue;
        float s = acc[mt][nt][i];
        if constexpr (kScaled) s *= scale[col];
        out[static_cast<int64_t>(row) * N + col] = __float2bfloat16(s);
      }
    }
  }
}

// The pipelined tile of bf16 @ int8 (pipelined(K, N): every 16-byte chunk
// wholly inside or outside the matrix).
// With gridDim.z = S > 1 (split K) block z sums its share of the K steps and
// stores the unscaled f32 partial to ws[z] ([M, N]); split_reduce_kernel
// adds the S partials in order (deterministic) and flushes.
template <typename TB, bool kScaled>
__global__ void __launch_bounds__(kMmaThreads)
mma_pipe_kernel(const bf16* __restrict__ a, const TB* __restrict__ b,
                const float* __restrict__ scale, bf16* __restrict__ out,
                float* __restrict__ ws, int M, int K, int N) {
  static_assert(sizeof(TB) == 1, "the pipelined tile widens int8 weights");
  constexpr int kBRow = kBN * static_cast<int>(sizeof(TB)) + 16;  // staged B row, bytes
  constexpr int kBChunks = kBN * static_cast<int>(sizeof(TB)) / 16;  // 16-byte chunks per row
  constexpr int kBElems = 16 / static_cast<int>(sizeof(TB));         // elements per chunk
  __shared__ __align__(16) uint16_t sa[kStages][kBM][kMmaBK + kPad];
  __shared__ __align__(16) uint8_t sb[kStages][kMmaBK][kBRow];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int ktotal = (K + kMmaBK - 1) / kMmaBK;
  const int per = (ktotal + gridDim.z - 1) / gridDim.z;
  const int kbeg = blockIdx.z * per;
  const int ksteps = max(0, min(ktotal, kbeg + per) - kbeg);  // this block's K steps

  auto load_stage = [&](int stage, int k0) {
#pragma unroll
    for (int i = tid; i < kBM * kMmaBK / 8; i += kMmaThreads) {  // 8 bf16 per chunk
      const int r = i / (kMmaBK / 8), kc = (i % (kMmaBK / 8)) * 8;
      const bool ok = m0 + r < M && k0 + kc < K;
      cp_async16(&sa[stage][r][kc], ok ? a + static_cast<int64_t>(m0 + r) * K + k0 + kc : a, ok);
    }
#pragma unroll
    for (int i = tid; i < kMmaBK * kBChunks; i += kMmaThreads) {
      const int r = i / kBChunks, nc = (i % kBChunks) * kBElems;
      const bool ok = k0 + r < K && n0 + nc < N;
      cp_async16(&sb[stage][r][nc * sizeof(TB)],
                 ok ? b + static_cast<int64_t>(k0 + r) * N + n0 + nc : b, ok);
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
    if (s < ksteps) load_stage(s, (kbeg + s) * kMmaBK);
    cp_async_commit();
  }
  for (int ks = 0; ks < ksteps; ++ks) {
    cp_async_wait<kStages - 2>();  // step ks has landed (this thread's copies)
    __syncthreads();               // ... and everyone's; step ks - 1's stage is free
    const int next = ks + kStages - 1;
    if (next < ksteps) load_stage(next % kStages, (kbeg + next) * kMmaBK);
    cp_async_commit();
    const int st = ks % kStages;
#pragma unroll
    for (int kk = 0; kk < kMmaBK; kk += 16) {
      uint32_t af[2][4], bfr[4][2];
      a_fragments(sa[st], wm, g, t4, kk, af);
      const int k = kk + t4 * 2;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = wn + nt * 8 + g;
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // rows k + 8h and k + 8h + 1 of column col
          const int kr = k + 8 * h;
          bfr[nt][h] = pack_int_bf16x2(i8_bits_to_f32(sb[st][kr][col]),
                                       i8_bits_to_f32(sb[st][kr + 1][col]));
        }
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_16816(acc[mt][nt], af[mt], bfr[nt]);
    }
  }
  cp_async_wait<0>();
  if (gridDim.z == 1) {
    store_tile<kScaled>(acc, scale, out, m0 + wm, n0 + wn, g, t4, M, N);
    return;
  }
  float* part = ws + static_cast<int64_t>(blockIdx.z) * M * N;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = m0 + wm + mt * 16 + g + (i >> 1) * 8;
        const int col = n0 + wn + nt * 8 + t4 * 2 + (i & 1);
        if (row < M && col < N) part[static_cast<int64_t>(row) * N + col] = acc[mt][nt][i];
      }
}

template <bool kScaled>
__global__ void __launch_bounds__(256)
split_reduce_kernel(const float* __restrict__ ws, int splits, const float* __restrict__ scale,
                    bf16* __restrict__ out, int M, int N) {
  const int64_t total = static_cast<int64_t>(M) * N;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += ws[z * total + i];
    if constexpr (kScaled) s *= scale[i % N];
    out[i] = __float2bfloat16(s);
  }
}

// K splits of the pipelined tile: at most 8, at least 8 K steps each, as
// many as fill the waves of (about) four 128-thread blocks per SM best;
// fewer splits win ties within 2% (each split adds an f32 partial of the
// output to write and read back). A forced split_k > 0 is taken as it is, up
// to one 32-deep K step per split.
int split_count(int M, int K, int N, int split_k) {
  if (split_k > 0) return std::min(split_k, (K + kMmaBK - 1) / kMmaBK);
  const int slots = 4 * device_sms();
  const int tiles = ((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
  const int most = std::max(1, std::min(8, (K + kMmaBK - 1) / kMmaBK / 8));
  int best = 1;
  double best_fill = -1.0;
  for (int s = 1; s <= most; ++s) {
    const int blocks = tiles * s;
    const double fill = static_cast<double>(blocks) / (((blocks + slots - 1) / slots) * slots);
    if (fill > best_fill + 0.02) {
      best_fill = fill;
      best = s;
    }
  }
  return best;
}

// The shapes the pipelined bf16 @ int8 tile takes (kernels/matmul.py::route).
bool pipelined(int K, int N) { return K % 8 == 0 && N % 16 == 0; }

// ------------------------------- tensor-core GEMV, M <= 64, bf16 a

// outT = bT aT on mma.sync m16n8k16: 16 weight columns are the mma's rows,
// the tokens its n8 columns, MR of them (8 at M <= 8: decode; 16, 32 or 64
// at 8 < M <= 64: wider decode steps, packs and admissions), so nothing is
// padded but the tokens past M. Block (x, y) owns the 128 columns [128 x,
// 128 x + 128) (a warp 32 of them, two mma tiles of 16) over the K steps
// [y per, (y + 1) per) of KS rows each (64 int8 or 32 bf16 rows: 8 KB of
// weights a step). The weight panel and the activations' slice stream
// through a kTcStages-deep cp.async ring; rows past K and columns past N
// are zero-filled.
//
// Fragments come from the row-major [k][n] tile by ldmatrix .trans, which
// hands each lane two consecutive k-rows of one 16-bit column: for bf16 that
// is one weight column, exactly a register of the mma's A fragment (row =
// column n, k pair), so a tile's fragment is one ldmatrix.x4. For int8 a
// 16-bit column is two weight columns: lane (g, t) gets the 2 x 2 bytes
// (k 2t, 2t + 1) x (n 2g, 2g + 1); the even bytes are column 2g's pair, the
// odd bytes (shifted down by 8) column 2g + 1's, which become the mma rows g
// and g + 8 of a tile, and each pair is widened to bf16 exactly (i8_bf16x2).
// A weight fragment is loaded and widened once a 16-row step and feeds the
// MR / 8 mmas of the token tiles. The activations' fragment (token g, k
// pair) of token tile j is one ldmatrix.x2 of the staged [MR][k] slice, or
// half of an ldmatrix.x4 that serves tiles j and j + 1. A 16-byte chunk c of
// staged weight row r sits at chunk c ^ (r & 7), so the eight rows an
// ldmatrix reads fall in eight different groups of four banks; the
// activation rows are padded to 36 or 20 words for the same reason.
//
// The accumulators of lane (g, t) in token tile j are tokens 8j + 2t and 8j
// + 2t + 1 at the columns tc_col gives. With gridDim.y = 1 they are scaled
// and stored; otherwise the f32 partial goes to ws[y] ([M, N]) and the last
// block of a strip (a ticket in counters[x], reset by that block) adds the
// partials in slice order, scales once and stores.
constexpr int kTcWarps = 4;
constexpr int kTcThreads = kTcWarps * 32;
constexpr int kTcCols = kTcWarps * 32;  // 128 columns a block, 32 a warp
constexpr int kTcStepBytes = 8192;      // weight bytes a K step
constexpr int kTcStages = 5;            // ring depth: 4 steps (32 KB of weights) in flight
constexpr int kTcAPad = 8;              // bf16 elements of padding a staged activation row
constexpr int kTcMaxRows = 64;          // the most tokens a block stages

template <typename TB>
__host__ __device__ constexpr int tc_rows() {  // K rows a step: 64 int8, 32 bf16
  return kTcStepBytes / (kTcCols * static_cast<int>(sizeof(TB)));
}

// Dynamic shared memory of a block: the weight ring, then the activations'
// (a stage of MR rows: 17 KB at MR 64 over int8, so two blocks share an SM).
template <typename TB, int MR>
constexpr int tc_smem_bytes() {
  return kTcStages * (kTcStepBytes + MR * (tc_rows<TB>() + kTcAPad) * 2);
}

// The tokens a block stages for M live ones: 8 (M <= 8), 16, 32 or 64; 0
// past kTcMaxRows.
__host__ __device__ constexpr int tc_token_rows(int M) {
  return M <= 8 ? 8 : M <= 16 ? 16 : M <= 32 ? 32 : M <= kTcMaxRows ? 64 : 0;
}

// The column of accumulator e of a lane's tile (tile 0 or 1) in its warp's
// 32: rows g (e < 2) and g + 8 (e >= 2) of the mma are columns 2g and 2g + 1
// (int8) or g and g + 8 (bf16) of the tile's 16.
template <typename TB>
__device__ __forceinline__ int tc_col(int tile, int e, int g) {
  const int half = e >> 1;
  return 16 * tile + (sizeof(TB) == 1 ? 2 * g + half : 8 * half + g);
}

// The two tiles' A fragments of a warp at step row kk of a staged weight
// panel (row-major, kRowBytes a row, chunks swizzled).
template <typename TB, int kRowBytes>
__device__ __forceinline__ void tc_fragments(const uint8_t* panel, int kk, int warp, int lane,
                                             uint32_t (&f0)[4], uint32_t (&f1)[4]) {
  const int j = lane >> 3, i = lane & 7;  // this lane's matrix and row of it
  if constexpr (sizeof(TB) == 1) {
    // matrix j: k-rows kk + 8 (j & 1) + 0..7, bytes 16 (j >> 1) .. + 15 of the warp's 32
    const int row = kk + 8 * (j & 1) + i;
    const int chunk = 2 * warp + (j >> 1);
    uint32_t r[4];
    ldsm_x4_trans(r, panel + row * kRowBytes + ((chunk ^ (row & 7)) << 4));
    f0[0] = i8_bf16x2(r[0]);
    f0[1] = i8_bf16x2(r[0] >> 8);
    f0[2] = i8_bf16x2(r[1]);
    f0[3] = i8_bf16x2(r[1] >> 8);
    f1[0] = i8_bf16x2(r[2]);
    f1[1] = i8_bf16x2(r[2] >> 8);
    f1[2] = i8_bf16x2(r[3]);
    f1[3] = i8_bf16x2(r[3] >> 8);
  } else {
    // tile q, matrix j: k-rows kk + 8 (j >> 1) + 0..7, columns 16 q + 8 (j & 1) + 0..7
    const int row = kk + 8 * (j >> 1) + i;
    const int chunk = 4 * warp + (j & 1);
    ldsm_x4_trans(f0, panel + row * kRowBytes + ((chunk ^ (row & 7)) << 4));
    ldsm_x4_trans(f1, panel + row * kRowBytes + (((chunk + 2) ^ (row & 7)) << 4));
  }
}

// The B fragments of the NT token tiles at step row kk of a staged [MR][kARow]
// activation slice: tile j's registers are (token 8j + g, k kk + 2t, + 1) and
// (token 8j + g, k kk + 8 + 2t, + 1). One ldmatrix.x2 serves a lone tile
// (lanes 0-15 address its 16 rows of 8 k), one ldmatrix.x4 a pair (lanes
// 16-31 address tile j + 1's).
template <int NT, int kARow>
__device__ __forceinline__ void tc_token_fragments(const uint16_t* slice, int kk, int lane,
                                                   uint32_t (&bfr)[NT][2]) {
  const int col = kk + 8 * ((lane >> 3) & 1);
  if constexpr (NT == 1) {
    ldsm_x2(bfr[0], slice + (lane & 7) * kARow + col);
  } else {
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t r[4];
      ldsm_x4(r, slice + (8 * (j + (lane >> 4)) + (lane & 7)) * kARow + col);
      bfr[j][0] = r[0];
      bfr[j][1] = r[1];
      bfr[j + 1][0] = r[2];
      bfr[j + 1][1] = r[3];
    }
  }
}

template <typename TB, bool kScaled, int MR>
__global__ void __launch_bounds__(kTcThreads)
gemv_tc_kernel(const bf16* __restrict__ a, const TB* __restrict__ b,
               const float* __restrict__ scale, bf16* __restrict__ out, float* __restrict__ ws,
               int* __restrict__ counters, int M, int K, int N, int per) {
  constexpr int KS = tc_rows<TB>();
  constexpr int NT = MR / 8;                                         // token tiles
  constexpr int kRowBytes = kTcCols * static_cast<int>(sizeof(TB));  // a staged weight row
  constexpr int kRowChunks = kRowBytes / 16;
  constexpr int kElems = 16 / static_cast<int>(sizeof(TB));  // weights a 16-byte chunk
  constexpr int kARow = KS + kTcAPad;                        // a staged activation row
  constexpr int kWCopies = KS * kRowChunks / kTcThreads;     // weight chunks a thread a step
  constexpr int kAChunks = KS / 8;                           // 16-byte chunks a token a step
  constexpr int kACopies = (MR * kAChunks + kTcThreads - 1) / kTcThreads;
  static_assert(kRowChunks % 8 == 0 && KS % 16 == 0, "the swizzle permutes groups of 8 chunks");
  static_assert(KS * kRowChunks % kTcThreads == 0, "a step is whole copies per thread");
  static_assert(MR % 8 == 0 && (NT == 1 || NT % 2 == 0), "token tiles come alone or in pairs");
  extern __shared__ __align__(128) uint8_t tc_smem[];  // tc_smem_bytes<TB, MR>()
  auto sb = reinterpret_cast<uint8_t (*)[KS * kRowBytes]>(tc_smem);  // [kTcStages]
  auto sa = reinterpret_cast<uint16_t (*)[MR][kARow]>(               // [kTcStages]
      tc_smem + kTcStages * KS * kRowBytes);
  __shared__ int last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kTcCols;
  const int ktotal = (K + KS - 1) / KS;
  const int kbeg = blockIdx.y * per;
  const int steps = max(0, min(ktotal, kbeg + per) - kbeg);

  // this thread's copies, the same in every step but for the step's first row
  int64_t w_src[kWCopies];
  int w_dst[kWCopies], w_row[kWCopies];
  bool w_col[kWCopies];
#pragma unroll
  for (int c = 0; c < kWCopies; ++c) {
    const int x = tid + c * kTcThreads;
    const int r = x / kRowChunks, ch = x % kRowChunks;
    const int col = n0 + ch * kElems;
    w_col[c] = col < N;
    w_row[c] = r;
    w_src[c] = static_cast<int64_t>(r) * N + col;
    w_dst[c] = r * kRowBytes + ((ch ^ (r & 7)) << 4);
  }
  int a_m[kACopies], a_k[kACopies];  // 8 bf16 a copy: token a_m, k a_k of the step
#pragma unroll
  for (int c = 0; c < kACopies; ++c) {
    const int x = tid + c * kTcThreads;
    a_m[c] = x / kAChunks;
    a_k[c] = (x % kAChunks) * 8;
  }
  // token rows past M stay zero (no copy writes them)
  for (int x = tid; x < kTcStages * (MR - M) * kARow; x += kTcThreads) {
    const int per_stage = (MR - M) * kARow;
    sa[x / per_stage][M + (x % per_stage) / kARow][x % kARow] = 0;
  }

  auto load_step = [&](int st, int i) {
    const int k0 = (kbeg + i) * KS;
    const TB* bk = b + static_cast<int64_t>(k0) * N;
#pragma unroll
    for (int c = 0; c < kWCopies; ++c) {
      const bool ok = w_col[c] && k0 + w_row[c] < K;
      cp_async16(&sb[st][w_dst[c]], ok ? bk + w_src[c] : b, ok);
    }
#pragma unroll
    for (int c = 0; c < kACopies; ++c) {
      if (a_m[c] >= M) continue;
      const bool ok = k0 + a_k[c] < K;
      cp_async16(&sa[st][a_m[c]][a_k[c]],
                 ok ? a + static_cast<int64_t>(a_m[c]) * K + k0 + a_k[c] : a, ok);
    }
  };

  float acc[2][NT][4] = {};  // [weight tile][token tile][accumulator]
#pragma unroll
  for (int s = 0; s < kTcStages - 1; ++s) {
    if (s < steps) load_step(s, s);
    cp_async_commit();
  }
  for (int i = 0; i < steps; ++i) {
    cp_async_wait<kTcStages - 2>();  // step i has landed (this thread's copies)
    __syncthreads();                 // ... and everyone's; step i - 1's stage is free
    const int nxt = i + kTcStages - 1;
    if (nxt < steps) load_step(nxt % kTcStages, nxt);
    cp_async_commit();
    const int st = i % kTcStages;
#pragma unroll
    for (int kk = 0; kk < KS; kk += 16) {
      uint32_t bfr[NT][2], f0[4], f1[4];
      tc_token_fragments<NT, kARow>(&sa[st][0][0], kk, lane, bfr);
      tc_fragments<TB, kRowBytes>(sb[st], kk, warp, lane, f0, f1);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        mma_16816(acc[0][j], f0, bfr[j]);
        mma_16816(acc[1][j], f1, bfr[j]);
      }
    }
  }
  cp_async_wait<0>();
  const int splits = gridDim.y;
  const int c0 = n0 + 32 * warp;  // the warp's columns; N % 16 == 0: a tile is all in or out
#pragma unroll
  for (int tile = 0; tile < 2; ++tile) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = 8 * j + 2 * t + (e & 1), col = c0 + tc_col<TB>(tile, e, g);
        if (m >= M || col >= N) continue;
        if (splits > 1) {
          ws[(static_cast<int64_t>(blockIdx.y) * M + m) * N + col] = acc[tile][j][e];
          continue;
        }
        float s = acc[tile][j][e];
        if constexpr (kScaled) s *= scale[col];
        out[static_cast<int64_t>(m) * N + col] = __float2bfloat16(s);
      }
    }
  }
  if (splits == 1) return;
  __threadfence();  // this block's partial is visible before its ticket
  __syncthreads();
  if (tid == 0) last = atomicAdd(&counters[blockIdx.x], 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int idx = tid; idx < M * (kTcCols / 4); idx += kTcThreads) {  // 4 columns a thread
    const int m = idx / (kTcCols / 4), c = n0 + 4 * (idx % (kTcCols / 4));
    if (c >= N) continue;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int z = 0; z < splits; ++z) {  // in slice order: the sum does not depend on timing
      const float4 p =
          __ldcg(reinterpret_cast<const float4*>(ws + (static_cast<int64_t>(z) * M + m) * N + c));
      s.x += p.x;
      s.y += p.y;
      s.z += p.z;
      s.w += p.w;
    }
    float r[4] = {s.x, s.y, s.z, s.w};
    if constexpr (kScaled) {
#pragma unroll
      for (int e = 0; e < 4; ++e) r[e] *= scale[c + e];
    }
    *reinterpret_cast<uint2*>(out + static_cast<int64_t>(m) * N + c) =
        make_uint2(pack_bf16(r[0], r[1]), pack_bf16(r[2], r[3]));
  }
  if (tid == 0) counters[blockIdx.x] = 0;  // ready for the next launch
}

// K splits of the tensor-core GEMV over steps of ks rows: forced (split_k >
// 0, at most one a step), or as many as keep the blocks at two an SM or
// fewer (at most 32). Fewer, longer block streams read the weight faster
// than more, shorter ones on the H100 at the serving widths
// (scripts/torch_gemm_ab.py; a forced-split sweep at M 1, 4 and 8, and with
// --splits at M 16, 37 and 64, where this rule's count was the fastest or
// within 1% of it at every staged width): the blocks of a split read the
// rows of one K range together.
int gemv_tc_splits(int K, int N, int ks, int split_k) {
  const int ktotal = (K + ks - 1) / ks;
  const int strips = (N + kTcCols - 1) / kTcCols;
  const int want = split_k > 0 ? split_k : std::min(32, std::max(1, 2 * device_sms() / strips));
  const int per = (ktotal + std::min(want, ktotal) - 1) / std::min(want, ktotal);
  return (ktotal + per - 1) / per;
}

// The shapes the tensor-core GEMV takes (kernels/matmul.py::route): M <= 8
// (gemv_tc) or 8 < M <= 64 (gemv_tc_rows), K and N multiples of 16.
bool tc_shape(int M, int K, int N) {
  return tc_token_rows(M) > 0 && K > 0 && K % 16 == 0 && N % 16 == 0;
}

template <typename TB, bool kScaled, int MR>
int launch_gemv_tc(const bf16* a, const TB* b, const float* scale, bf16* out, float* ws,
                   int* counters, int M, int K, int N, int split_k, cudaStream_t st) {
  constexpr int ks = tc_rows<TB>();
  const int splits = gemv_tc_splits(K, N, ks, split_k);
  if (splits > 1 && (ws == nullptr || counters == nullptr)) return -3;
  const int ktotal = (K + ks - 1) / ks;
  const dim3 grid((N + kTcCols - 1) / kTcCols, splits);
  constexpr int bytes = tc_smem_bytes<TB, MR>();
  static bool raised[64];
  const cudaError_t err = repro::raise_smem(gemv_tc_kernel<TB, kScaled, MR>, bytes, raised);
  if (err != cudaSuccess) return static_cast<int>(err);
  gemv_tc_kernel<TB, kScaled, MR><<<grid, kTcThreads, bytes, st>>>(
      a, b, scale, out, ws, counters, M, K, N, (ktotal + splits - 1) / splits);
  return static_cast<int>(cudaGetLastError());
}

// Any shape: the tiles staged synchronously, widened to bf16 on the way.
template <typename TB, bool kScaled>
__global__ void __launch_bounds__(kMmaThreads)
mma_tile_kernel(const bf16* __restrict__ a, const TB* __restrict__ b,
                const float* __restrict__ scale, bf16* __restrict__ out, int M, int K, int N) {
  // A as [m][k], B as [k][n], both bf16 bits
  __shared__ __align__(16) uint16_t sa[kBM][kMmaBK + kPad];
  __shared__ __align__(16) uint16_t sb[kMmaBK][kBN + kPad];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kMmaBK) {
    for (int i = tid; i < kBM * kMmaBK / 4; i += kMmaThreads) {
      const int r = i / (kMmaBK / 4), kc = (i % (kMmaBK / 4)) * 4;
      float v[4];
      load4(a, m0 + r, k0 + kc, M, K, v);
      *reinterpret_cast<uint2*>(&sa[r][kc]) = make_uint2(pack_bf16(v[0], v[1]),
                                                         pack_bf16(v[2], v[3]));
    }
    for (int i = tid; i < kMmaBK * kBN / 4; i += kMmaThreads) {
      const int r = i / (kBN / 4), nc = (i % (kBN / 4)) * 4;
      float v[4];
      load4(b, k0 + r, n0 + nc, K, N, v);  // int8 or bf16 -> bf16: exact
      *reinterpret_cast<uint2*>(&sb[r][nc]) = make_uint2(pack_bf16(v[0], v[1]),
                                                         pack_bf16(v[2], v[3]));
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kMmaBK; kk += 16) {
      uint32_t af[2][4], bfr[4][2];
      a_fragments(sa, wm, g, t4, kk, af);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = wn + nt * 8 + g;
        const int k = kk + t4 * 2;
        bfr[nt][0] = static_cast<uint32_t>(sb[k][col]) | (static_cast<uint32_t>(sb[k + 1][col]) << 16);
        bfr[nt][1] = static_cast<uint32_t>(sb[k + 8][col]) |
                     (static_cast<uint32_t>(sb[k + 9][col]) << 16);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_16816(acc[mt][nt], af[mt], bfr[nt]);
    }
    __syncthreads();
  }
  store_tile<kScaled>(acc, scale, out, m0 + wm, n0 + wn, g, t4, M, N);
}

// --------------------------------------------- bf16 @ bf16: the wgmma tile

using repro::kGemmBK;
using repro::kGemmBM;

// gemm_wgmma.cuh's policy for C = A B: block (x, y, z) computes rows
// [128 x, 128 x + 128) and columns [BN y, BN y + BN) over K split z's steps
// [z per, (z + 1) per).
struct GemmTiles {
  CUtensorMap a;  // A [M, K]: boxes of 64 k x 128 rows, K-major
  CUtensorMap b;  // B [K, N]: boxes of 64 columns x 64 k, MN-major
  int M, N, ktotal, per;

  __device__ __forceinline__ int k_steps() const {
    const int beg = blockIdx.z * per;
    return max(0, min(ktotal, beg + per) - beg);
  }
  template <int BN>
  __device__ __forceinline__ void load(int i, uint8_t* sa, uint8_t* sb, uint64_t* bar,
                                       int n0) const {
    const int k0 = (blockIdx.z * per + i) * kGemmBK;
    repro::tma_load(sa, &a, bar, k0, blockIdx.x * kGemmBM);
#pragma unroll
    for (int j = 0; j < BN / 64; ++j)
      repro::tma_load(sb + j * 64 * 128, &b, bar, n0 + 64 * j, k0);
  }
  __device__ __forceinline__ int64_t out_row(int r) const {
    const int m = blockIdx.x * kGemmBM + r;
    return m < M ? static_cast<int64_t>(m) * N : -1;
  }
  __device__ __forceinline__ int64_t plane() const { return static_cast<int64_t>(M) * N; }
};

struct WgPlan {
  int bn, splits;  // the tile's columns; K splits (each one at least one K step)
};

// The wgmma tile's columns and K splits, each as forced (block_n, split_k)
// or chosen:
// - block_n 256 where its tiles fill a third of the SMs or more (one such
//   tile streams its B panel faster than two 128-wide ones; on the H100 at
//   M 16-300 over N 13440), else 128;
// - split_k from 1 to 8 (at least 4 K steps each), the one a roofline
//   estimate of the launch prefers: max(waves x one block's time, the main
//   kernel's bytes at the 3.35 TB/s of HBM: A, B, and C or the f32
//   partials), plus 2 us a wave, plus, for a split, the reduce's bytes and
//   3 us. A block's time is the longer of its wgmma work at 90% of an SM's
//   share of the 989 TFLOP/s and its A and B tiles' bytes at 70 GB/s an SM
//   (what a block streams from L2 and HBM). A split must beat the one
//   before it by 2%.
WgPlan wgmma_plan(int M, int K, int N, int split_k, int block_n) {
  const int ktotal = (K + kGemmBK - 1) / kGemmBK;
  const int sms = device_sms();
  const int64_t m_tiles = (M + kGemmBM - 1) / kGemmBM;
  const int bn = block_n != 0                                ? block_n
                 : 3 * m_tiles * ((N + 255) / 256) >= sms ? 256
                                                            : 128;
  const int64_t tiles = m_tiles * ((N + bn - 1) / bn);
  const double mn = static_cast<double>(M) * N;
  const int lo = split_k > 0 ? std::min(split_k, ktotal) : 1;
  const int hi = split_k > 0 ? lo : std::max(1, std::min(8, ktotal / 4));
  WgPlan best{bn, 1};
  double best_cost = 1e300;
  for (int s = lo; s <= hi; ++s) {
    const int per = (ktotal + s - 1) / s;
    const int eff = (ktotal + per - 1) / per;
    const int64_t waves = (tiles * eff + sms - 1) / sms;
    const double t_mma = (2.0 * kGemmBM * bn * per * kGemmBK) / (0.9 * 989e6 / 132);
    const double t_tiles = 2.0 * (std::min(M, kGemmBM) + bn) * per * kGemmBK / 70e3;
    const double out = eff > 1 ? 4.0 * eff * mn : 2.0 * mn;
    const double t_hbm = (2.0 * M * K + 2.0 * K * N + out) / 3.35e6;
    double cost = std::max(waves * std::max(t_mma, t_tiles), t_hbm) + 2.0 * waves;
    if (eff > 1) cost += (4.0 * eff * mn + 2.0 * mn) / 3.35e6 + 3.0;
    if (cost < 0.98 * best_cost) {
      best_cost = cost;
      best = {bn, eff};
    }
  }
  return best;
}

template <int BN>
int launch_wgmma_bn(const bf16* a, const bf16* b, bf16* out, float* ws, int M, int K, int N,
                    int splits, cudaStream_t st) {
  GemmTiles t;
  const cuuint64_t a_dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(M)};
  const cuuint64_t a_strides[1] = {static_cast<cuuint64_t>(K) * 2};
  const cuuint32_t a_box[2] = {kGemmBK, kGemmBM};
  const cuuint64_t b_dims[2] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(K)};
  const cuuint64_t b_strides[1] = {static_cast<cuuint64_t>(N) * 2};
  const cuuint32_t b_box[2] = {64, kGemmBK};
  if (!repro::encode_map(&t.a, a, 2, a_dims, a_strides, a_box) ||
      !repro::encode_map(&t.b, b, 2, b_dims, b_strides, b_box))
    return static_cast<int>(cudaErrorInvalidValue);
  t.M = M;
  t.N = N;
  t.ktotal = (K + kGemmBK - 1) / kGemmBK;
  t.per = (t.ktotal + splits - 1) / splits;
  const dim3 grid((M + kGemmBM - 1) / kGemmBM, (N + BN - 1) / BN, splits);
  if (grid.y > 65535 || grid.z > 65535) return -1;
  const int rc = repro::launch_gemm_wgmma<BN>(t, grid, out, splits > 1 ? ws : nullptr, st);
  if (rc != 0 || splits == 1) return rc;
  const int64_t total = static_cast<int64_t>(M) * N;
  const int blocks = static_cast<int>(std::min<int64_t>((total + 255) / 256, 4096));
  split_reduce_kernel<false><<<blocks, 256, 0, st>>>(ws, splits, nullptr, out, M, N);
  return static_cast<int>(cudaGetLastError());
}

int launch_wgmma(const bf16* a, const bf16* b, bf16* out, float* ws, int M, int K, int N,
                 int split_k, int block_m, int block_n, cudaStream_t st) {
  if (K % 8 || N % 8 || (block_m != 0 && block_m != kGemmBM) ||
      (block_n != 0 && block_n != 128 && block_n != 256) || (block_m == 0) != (block_n == 0))
    return -1;
  const WgPlan plan = wgmma_plan(M, K, N, split_k, block_n);
  if (plan.splits > 1 && ws == nullptr) return -3;
  return plan.bn == 256 ? launch_wgmma_bn<256>(a, b, out, ws, M, K, N, plan.splits, st)
                        : launch_wgmma_bn<128>(a, b, out, ws, M, K, N, plan.splits, st);
}

// f32 activations: CUDA-core FMA, 256 threads of 4 x 4 outputs.
constexpr int kFmaBK = 16;
constexpr int kFmaThreads = 256;

template <typename TB, bool kScaled>
__global__ void __launch_bounds__(kFmaThreads)
fma_tile_kernel(const float* __restrict__ a, const TB* __restrict__ b,
                const float* __restrict__ scale, float* __restrict__ out, int M, int K, int N) {
  __shared__ __align__(16) float sa[kFmaBK][kBM + 4];  // A transposed: [k][m]
  __shared__ __align__(16) float sb[kFmaBK][kBN + 4];  // [k][n]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kFmaBK) {
    {  // A: 64 rows x 16 k, one 4-wide chunk per thread
      const int r = tid / 4, kc = (tid % 4) * 4;
      float v[4];
      load4(a, m0 + r, k0 + kc, M, K, v);
#pragma unroll
      for (int j = 0; j < 4; ++j) sa[kc + j][r] = v[j];
    }
    {  // B: 16 k x 64 columns, one 4-wide chunk per thread
      const int r = tid / 16, nc = (tid % 16) * 4;
      float v[4];
      load4(b, k0 + r, n0 + nc, K, N, v);
      *reinterpret_cast<float4*>(&sb[r][nc]) = make_float4(v[0], v[1], v[2], v[3]);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kFmaBK; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&sa[k][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&sb[k][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (row >= M || col >= N) continue;
      float s = acc[i][j];
      if constexpr (kScaled) s *= scale[col];
      out[static_cast<int64_t>(row) * N + col] = s;
    }
  }
}

// The bodies, as kernels/matmul.py::route names them.
enum Route {
  kGemv = 0, kWgmma = 1, kMmaPipe = 2, kMmaTile = 3, kFma = 4, kGemvTc = 5, kGemvTcRows = 6
};

template <typename TA, typename TB, bool kScaled>
int launch(int route, const void* a_, const void* b_, const void* scale_, void* out_, void* ws,
           int* counters, int M, int K, int N, int split_k, int block_m, int block_n,
           cudaStream_t st) {
  const TA* a = static_cast<const TA*>(a_);
  const TB* b = static_cast<const TB*>(b_);
  const float* scale = static_cast<const float*>(scale_);
  TA* out = static_cast<TA*>(out_);
  if (route == kGemv) {
    if (M > kGemvMaxM) return -1;
    const int slice = gemv_slice(M, K, N, split_k);
    const int splits = (K + slice - 1) / slice;
    if (splits > 1 && (ws == nullptr || counters == nullptr)) return -3;
    const dim3 grid((N + kGemvCols - 1) / kGemvCols, std::max(splits, 1));
    float* part = static_cast<float*>(ws);
#define REPRO_GEMV(MR)                                                                  \
  gemv_kernel<TA, TB, kScaled, MR><<<grid, kGemvThreads, 0, st>>>(a, b, scale, out, part, \
                                                                counters, M, K, N, slice)
    if (M <= 4) {
      REPRO_GEMV(4);
    } else {
      REPRO_GEMV(8);
    }
#undef REPRO_GEMV
    return static_cast<int>(cudaGetLastError());
  }
  if (route == kGemvTc || route == kGemvTcRows) {
    // gemv_tc stages 8 tokens at M <= 8; gemv_tc_rows 16, 32 or 64 at 8 < M
    // <= 64, over int8 weights only (bf16 weights take the wgmma tile there)
    if constexpr (std::is_same_v<TA, bf16> && (std::is_same_v<TB, int8_t> ||
                                                std::is_same_v<TB, bf16>)) {
      if (!tc_shape(M, K, N) || (route == kGemvTc) != (M <= kGemvMaxM)) return -1;
      float* part = static_cast<float*>(ws);
      switch (tc_token_rows(M)) {
        case 8:
          return launch_gemv_tc<TB, kScaled, 8>(a, b, scale, out, part, counters, M, K, N,
                                                split_k, st);
        case 16:
          if constexpr (std::is_same_v<TB, int8_t>)
            return launch_gemv_tc<TB, kScaled, 16>(a, b, scale, out, part, counters, M, K, N,
                                                   split_k, st);
          break;
        case 32:
          if constexpr (std::is_same_v<TB, int8_t>)
            return launch_gemv_tc<TB, kScaled, 32>(a, b, scale, out, part, counters, M, K, N,
                                                   split_k, st);
          break;
        case 64:
          if constexpr (std::is_same_v<TB, int8_t>)
            return launch_gemv_tc<TB, kScaled, 64>(a, b, scale, out, part, counters, M, K, N,
                                                   split_k, st);
          break;
      }
    }
    return -1;
  }
  if (M <= kGemvMaxM) return -1;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  if constexpr (std::is_same_v<TA, bf16>) {
    if (route == kWgmma) {
      if constexpr (std::is_same_v<TB, bf16> && !kScaled)
        return launch_wgmma(a, b, out, static_cast<float*>(ws), M, K, N, split_k, block_m,
                            block_n, st);
      return -1;
    }
    if (route == kMmaPipe) {
      if constexpr (std::is_same_v<TB, int8_t>) {
        if (!pipelined(K, N)) return -1;
        const int splits = ws ? split_count(M, K, N, split_k) : 1;
        const dim3 grid3(grid.x, grid.y, splits);
        mma_pipe_kernel<TB, kScaled><<<grid3, kMmaThreads, 0, st>>>(
            a, b, scale, out, static_cast<float*>(ws), M, K, N);
        if (splits > 1) {
          const int64_t total = static_cast<int64_t>(M) * N;
          const int blocks = static_cast<int>(std::min<int64_t>((total + 255) / 256, 4096));
          split_reduce_kernel<kScaled><<<blocks, 256, 0, st>>>(static_cast<const float*>(ws),
                                                                splits, scale, out, M, N);
        }
        return static_cast<int>(cudaGetLastError());
      }
      return -1;
    }
    if (route != kMmaTile) return -1;
    mma_tile_kernel<TB, kScaled><<<grid, kMmaThreads, 0, st>>>(a, b, scale, out, M, K, N);
  } else {
    if (route != kFma) return -1;
    fma_tile_kernel<TB, kScaled><<<grid, kFmaThreads, 0, st>>>(a, b, scale, out, M, K, N);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// f32 elements of scratch repro_matmul needs for this route, these shapes,
// knobs and weight type (bdtype, a repro::DType code): the K-split partials
// of either GEMV, the wgmma tile or the pipelined int8 tile, 0 when the
// product is not split.
extern "C" long long repro_matmul_workspace(int M, int K, int N, int route, int split_k,
                                            int block_n, int bdtype) {
  long long splits = 1;
  if (route == kGemv) {
    const int slice = gemv_slice(M, K, N, split_k);
    splits = (K + slice - 1) / slice;
  } else if (route == kGemvTc || route == kGemvTcRows) {
    const int ks = bdtype == repro::kI8 ? tc_rows<int8_t>() : tc_rows<bf16>();
    if (tc_shape(M, K, N)) splits = gemv_tc_splits(K, N, ks, split_k);
  } else if (route == kWgmma) {
    splits = wgmma_plan(M, K, N, split_k, block_n).splits;
  } else if (route == kMmaPipe && pipelined(K, N)) {
    splits = split_count(M, K, N, split_k);
  }
  return splits > 1 ? splits * M * N : 0;
}

// route: the body (Route; kernels/matmul.py::ROUTES). adtype: the type of a
// and out; bdtype: the type of b (repro::DType codes). scale: null for
// matmul, f32 [N] for matmul_q8. ws: the f32 scratch repro_matmul_workspace
// asks for (null when it asks for none); counters: int32 zeros, one per 128
// columns (ceil(N / 128)), left zero again. The served combinations are f32
// @ f32 and bf16 @ bf16 unscaled, f32 @ int8 and bf16 @ int8 scaled.
// split_k: 0 lets the kernel split K; 1, 2, 4, 8, ... force that many K
// splits where the body splits (the GEMV, at least as many as its shared
// memory needs; the wgmma and the pipelined tiles, at most one per K step);
// block_m x block_n: the wgmma tile, 0 x 0 for the kernel's choice, 128 x
// 128 or 128 x 256. Returns cudaGetLastError() after the launches, -1 for a
// route or knob the operands do not take, -2 for any other combination of
// types, -3 for a missing scratch.
extern "C" int repro_matmul(const void* a, const void* b, const void* scale, void* ws,
                            void* counters_, void* out, int M, int K, int N, int adtype,
                            int bdtype, int route, int split_k, int block_m, int block_n,
                            void* stream) {
  int* counters = static_cast<int*>(counters_);
  using repro::kBF16;
  using repro::kF32;
  using repro::kI8;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool scaled = scale != nullptr;
#define REPRO_MM(TA, TB, S) \
  launch<TA, TB, S>(route, a, b, scale, out, ws, counters, M, K, N, split_k, block_m, block_n, st)
  if (adtype == kF32 && bdtype == kF32 && !scaled) return REPRO_MM(float, float, false);
  if (adtype == kF32 && bdtype == kI8 && scaled) return REPRO_MM(float, int8_t, true);
  if (adtype == kBF16 && bdtype == kBF16 && !scaled) return REPRO_MM(bf16, bf16, false);
  if (adtype == kBF16 && bdtype == kI8 && scaled) return REPRO_MM(bf16, int8_t, true);
#undef REPRO_MM
  return -2;
}
