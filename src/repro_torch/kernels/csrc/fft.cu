// Batched radix-2 Stockham FFT over the last dim, planar re/im (the paper's
// synchronisation-critical DSP kernel).
//
// Replaces the TPU kernel repro/kernels/fft.py::fft (_fft_kernel): re, im
// [B, N] of one type (f32 or bf16), N = 2^k from 2 to 16,384 in fft_kernel
// (longer rows: the four-step transposes at the end of this file around two
// batches of fft_kernel, composed by kernels/fft.py); out re, im [B, N] in
// that type; all math in f32. Stage s (L = 2^s) views each half of the row
// as [N / 2L, L], multiplies the second half by W_2L^j (j = p mod L) and
// writes [e + t, e - t] side by side. The products and sums round as the
// plain Stockham version's separate operations do (__fmul_rn, __fadd_rn, no
// contraction), on the same twiddle bits, so at f32 the result equals
// ref.fft_stockham.
//
// What bounds it on the H100: the bytes — each row read once and written
// once (0.641 ms at B = 8192, N = 16,384 f32 at 3.35 TB/s); 5 N log2 N
// flops per row are a fifth of that at the f32 rate, but the butterflies
// round each product alone (no FMA), so they take about half of it.
//
// Design (ref.fft_stockham_passes is its plain twin):
// - Passes of four stages in registers. In index bits, stage s takes the
//   top bit of the row index, pairs over it and writes the result bit at
//   position s; the bits below s stay, the bits between shift up. So the 16
//   points t * N / 16 + q (t < 16; q = m * 2^s + j, j < 2^s) go through
//   stages s .. s + 3 among themselves and land at m * 2^(s+4) + u * 2^s + j
//   (u < 16). A thread holds 16 points and runs such a radix-16 group (or,
//   in the last pass of R = log2 N - 4 * (passes - 1) stages, 16 / 2^R
//   radix-2^R groups) through its stages in registers. A 16,384-point row
//   takes four passes (4 + 4 + 4 + 2 stages), 1,024 threads, and three
//   exchanges through shared memory (13 barriers a row), where a stage at a
//   time took 14 stages and 42 barriers.
// - Registers are the limit: 1,024 threads may hold 64 each, and a group
//   takes 32. log2 N is a template parameter, so every stride of a pass is
//   a compile-time constant and a group's loads, stores and twiddle reads
//   are one base address plus immediate offsets; and a pass reads
//   threadIdx.x anew (tid()), so its offsets are computed where they are
//   used instead of kept live across the row. Without the first the
//   addresses outnumbered the points and the passes spilled (at 128
//   registers with 32 points a thread too); without the second the
//   bulk-copy kernels still spilled about 550 bytes a thread a row, more
//   than L1 holds beside 192 KB of shared memory, so the spills went to L2.
// - One twiddle table of N - 1 entries: stage s's distinct L = 2^s entries
//   W_2L^p at offset L - 1 (ref.fft_twiddle_stages), each the TPU table's
//   entry bit for bit (read from its last row at p * N / 2L, an exact power
//   of two apart in angle), re and im interleaved: one 8-byte load a
//   twiddle, a warp's loads one or two 128-byte lines in every pass (128 KB
//   at N = 16,384, through the read-only cache). Read from the last row
//   with its stride N / 2L instead, a warp's twiddle loads in the middle
//   passes touch 32 lines each and the passes wait on L2.
// - Two buffers. The tile lands, dense and in its own type, in two landing
//   planes; the passes exchange through one f32 exchange plane, re then im
//   (four barriers an exchange). So the landing planes are free once the
//   first pass has read them.
// - The exchange plane is swizzled: word i lives at i ^ g(i / 32), g(r) =
//   (r & 15) | ((r & 8) << 1), a permutation inside each 32-word row. A pass
//   reads 32 consecutive words a warp (any layout of that kind is
//   conflict-free), and the writes of the passes at s = 0 (16 consecutive
//   words a thread) and s = 4 (two 16-word runs 256 apart a warp), 16- and
//   2-way bank conflicts in a plain layout, become conflict-free; from s = 5
//   on the writes are runs of 32.
// - Persistent blocks overlap the HBM traffic with the passes: as many
//   blocks as fit an SM walk the tiles of `rows` rows. A tile lands by two
//   cp.async.bulk (TMA bulk) copies, one a plane, completed on an mbarrier;
//   as soon as every thread has read the first pass's inputs, one thread
//   issues the bulk copies of the block's next tile into the landing planes,
//   so that load runs during the later passes; the last pass writes its
//   outputs from registers straight to global memory, group by group. Rows
//   whose bytes or pointers are not 16-byte aligned (N * sizeof(T) % 16 !=
//   0, an offset view) are copied in by the threads instead, at the top of
//   each tile.
// `rows` is the autotuner's knob (block_rows: 1, 2, 4 or 8 with rows * N <=
// 16,384, or 0 for the kernel's choice, the most rows up to 8 within 4,096
// elements). A block has max(32, rows * N / 16) threads and (2 sizeof(T) +
// 4) rows * N bytes of shared memory (192 KiB for one f32 row of 16,384).

#include <algorithm>

#include "attention_common.cuh"
#include "gemm_wgmma.cuh"

namespace {

constexpr int kMaxElems = 16384;  // rows * N of one block
constexpr int kPoints = 16;       // complex points a thread holds
constexpr int kMaxThreads = kMaxElems / kPoints;

// dynamic shared memory of a block: the landing re and im planes of T, the
// f32 exchange plane and the mbarrier
__host__ __device__ constexpr int smem_bytes(int cap, int tsize) {
  return (2 * tsize + static_cast<int>(sizeof(float))) * cap + 16;
}

// word i of the exchange plane (see the design note)
__device__ __forceinline__ int swz(int i) {
  const int r = i >> 5;
  return i ^ ((r & 15) | ((r & 8) << 1));
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(repro::smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
      "r"(repro::smem_addr(bar))
      : "memory");
}

// The rows and sizes of a launch.
template <typename T>
struct Rows {
  const T* re;
  const T* im;
  T* ore;
  T* oim;
  const float2* tw;  // the stage twiddles, N - 1 entries (re, im)
  int B, rows, cap;  // cap = rows * N, the elements of a full tile
};

// threadIdx.x, read anew at each use: a pass's offsets are then computed
// where they are used instead of kept live (and spilled) across the row.
__device__ __forceinline__ int tid() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;\n" : "=r"(t));
  return t;
}

// The pass of R stages from stage S over rows of 2^LOG2N points: a thread's
// groups q = threadIdx.x + g * blockDim.x (g < kGroups) of the tile's valid
// groups; group q = (row, m * 2^S + j) reads its element t at in0 + t *
// 2^(LOG2N - R) and writes its output u at out0 + u * 2^S. Every stride is a
// compile-time constant, so a group's loads and stores are one base address
// plus immediate offsets.
template <int LOG2N, int S, int R>
struct Pass {
  static constexpr int kRadix = 1 << R, kGroups = kPoints / kRadix, kLog2G = LOG2N - R;
  int groups;
  __device__ explicit Pass(int valid) : groups(valid >> R) {}
  __device__ static int q(int g) { return tid() + g * blockDim.x; }
  __device__ bool live(int g) const { return q(g) < groups; }
  __device__ static int j(int g) { return q(g) & ((1 << S) - 1); }
  __device__ static int in0(int g) {
    return ((q(g) >> kLog2G) << LOG2N) + (q(g) & ((1 << kLog2G) - 1));
  }
  __device__ static int out0(int g) {
    const int qp = q(g) & ((1 << kLog2G) - 1);
    return ((q(g) >> kLog2G) << LOG2N) + ((qp >> S) << (S + R)) + (qp & ((1 << S) - 1));
  }
};

// Element e0 + off of the exchange plane, sw0 = swz(e0): a stride of 512
// words or more leaves the swizzle's bits alone, so the offset stays an
// immediate.
template <int kLog2Stride>
__device__ __forceinline__ int swz_at(int e0, int sw0, int off) {
  if constexpr (kLog2Stride >= 9) return sw0 + off;
  return swz(e0 + off);
}

// Stage S + K of the radix-2^R group at registers xr[o ..], xi[o ..], then
// the group's later stages. The group sits at local index (remaining input
// bits << K) | produced bits; the stage pairs over the top local bit, and
// its twiddle for produced bits p is W_2L^(p * 2^S + j), L = 2^(S + K):
// entry L - 1 + p * 2^S + j of the stage table.
template <int LOG2N, int S, int R, int K>
__device__ __forceinline__ void radix_stages(float (&xr)[kPoints], float (&xi)[kPoints], int o,
                                             int j, const float2* __restrict__ tw) {
  constexpr int kHalf = 1 << (R - 1);
  const float2* twj = tw + ((1 << (S + K)) - 1) + j;  // the stage's entries
  float nr[1 << R], ni[1 << R];
#pragma unroll
  for (int p = 0; p < (1 << K); ++p) {
    const float2 w = __ldg(twj + (p << S));
#pragma unroll
    for (int rp = 0; rp < (kHalf >> K); ++rp) {
      const int l = (rp << K) | p;  // e at l, o at l + kHalf
      const float er = xr[o + l], ei = xi[o + l], orr = xr[o + l + kHalf],
                  oi = xi[o + l + kHalf];
      const float t_r = __fsub_rn(__fmul_rn(orr, w.x), __fmul_rn(oi, w.y));
      const float t_i = __fadd_rn(__fmul_rn(orr, w.y), __fmul_rn(oi, w.x));
      const int lo = (rp << (K + 1)) | p;
      nr[lo] = __fadd_rn(er, t_r);
      ni[lo] = __fadd_rn(ei, t_i);
      nr[lo | (1 << K)] = __fsub_rn(er, t_r);
      ni[lo | (1 << K)] = __fsub_rn(ei, t_i);
    }
  }
#pragma unroll
  for (int l = 0; l < (1 << R); ++l) {
    xr[o + l] = nr[l];
    xi[o + l] = ni[l];
  }
  if constexpr (K + 1 < R) radix_stages<LOG2N, S, R, K + 1>(xr, xi, o, j, tw);
}

// The first pass's inputs, from the landed tile (T, dense).
template <int LOG2N, int S, int R, typename T>
__device__ __forceinline__ void load_landed(float (&xr)[kPoints], float (&xi)[kPoints],
                                            const Pass<LOG2N, S, R>& ps, const T* lre,
                                            const T* lim) {
  using P = Pass<LOG2N, S, R>;
#pragma unroll
  for (int g = 0; g < P::kGroups; ++g) {
    if (!ps.live(g)) continue;
    const int e0 = P::in0(g);
#pragma unroll
    for (int t = 0; t < P::kRadix; ++t) {
      xr[g * P::kRadix + t] = repro::to_f32(lre[e0 + (t << P::kLog2G)]);
      xi[g * P::kRadix + t] = repro::to_f32(lim[e0 + (t << P::kLog2G)]);
    }
  }
}

template <int LOG2N, int S, int R>
__device__ __forceinline__ void butterflies(float (&xr)[kPoints], float (&xi)[kPoints],
                                            const Pass<LOG2N, S, R>& ps, const float2* tw) {
  using P = Pass<LOG2N, S, R>;
#pragma unroll
  for (int g = 0; g < P::kGroups; ++g)
    if (ps.live(g)) radix_stages<LOG2N, S, R, 0>(xr, xi, g * P::kRadix, P::j(g), tw);
}

// One plane of the registers from pass a's outputs to pass b's inputs
// through the exchange plane xs (swizzled), in place in the registers.
template <int LOG2N, int SA, int RA, int SB, int RB>
__device__ __forceinline__ void exchange_plane(float (&x)[kPoints],
                                               const Pass<LOG2N, SA, RA>& a,
                                               const Pass<LOG2N, SB, RB>& b, float* xs) {
  using A = Pass<LOG2N, SA, RA>;
  using B = Pass<LOG2N, SB, RB>;
  __syncthreads();  // the plane is free: every thread has read its last use
#pragma unroll
  for (int g = 0; g < A::kGroups; ++g) {
    if (!a.live(g)) continue;
    const int e0 = A::out0(g), sw0 = swz(e0);
#pragma unroll
    for (int u = 0; u < A::kRadix; ++u) xs[swz_at<SA>(e0, sw0, u << SA)] = x[g * A::kRadix + u];
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < B::kGroups; ++g) {
    if (!b.live(g)) continue;
    const int e0 = B::in0(g), sw0 = swz(e0);
#pragma unroll
    for (int t = 0; t < B::kRadix; ++t)
      x[g * B::kRadix + t] = xs[swz_at<B::kLog2G>(e0, sw0, t << B::kLog2G)];
  }
}

// The last pass's butterflies, each group written to global memory as soon
// as its stages are done.
template <int LOG2N, int S, int R, typename T>
__device__ __forceinline__ void butterflies_out(float (&xr)[kPoints], float (&xi)[kPoints],
                                                const Pass<LOG2N, S, R>& ps, const float2* tw,
                                                T* ore, T* oim) {
  using P = Pass<LOG2N, S, R>;
#pragma unroll
  for (int g = 0; g < P::kGroups; ++g) {
    if (!ps.live(g)) continue;
    radix_stages<LOG2N, S, R, 0>(xr, xi, g * P::kRadix, P::j(g), tw);
    T* pr = ore + P::out0(g);
    T* pi = oim + P::out0(g);
#pragma unroll
    for (int u = 0; u < P::kRadix; ++u) {
      repro::store_f32(pr + (u << S), xr[g * P::kRadix + u]);
      repro::store_f32(pi + (u << S), xi[g * P::kRadix + u]);
    }
  }
}

// The passes from stage S on; the registers hold the outputs of the
// radix-16 pass from stage S - 4.
template <int LOG2N, int S, typename T>
__device__ __forceinline__ void passes_from(float (&xr)[kPoints], float (&xi)[kPoints],
                                            int valid, float* xs, const float2* tw, T* ore,
                                            T* oim) {
  constexpr int R = LOG2N - S < 4 ? LOG2N - S : 4;
  const Pass<LOG2N, S - 4, 4> prev(valid);
  const Pass<LOG2N, S, R> cur(valid);
  exchange_plane(xr, prev, cur, xs);
  exchange_plane(xi, prev, cur, xs);
  if constexpr (S + R == LOG2N) {
    butterflies_out(xr, xi, cur, tw, ore, oim);
  } else {
    butterflies(xr, xi, cur, tw);
    passes_from<LOG2N, S + 4>(xr, xi, valid, xs, tw, ore, oim);
  }
}

// Rows of 2^LOG2N points; kBulk: tiles land by TMA bulk copies (16-byte
// aligned rows and pointers), else by the threads.
template <typename T, int LOG2N, bool kBulk>
__global__ void __launch_bounds__(kMaxThreads, 1) fft_kernel(const Rows<T> a) {
  constexpr int n = 1 << LOG2N, R0 = LOG2N < 4 ? LOG2N : 4;
  extern __shared__ __align__(16) unsigned char smem[];
  T* lre = reinterpret_cast<T*>(smem);
  T* lim = lre + a.cap;
  float* xs = reinterpret_cast<float*>(lim + a.cap);
  uint64_t* bar = reinterpret_cast<uint64_t*>(xs + a.cap);
  const int tiles = (a.B + a.rows - 1) / a.rows;

  // the bulk copies of tile `tile` into the landing planes (one thread)
  auto issue = [&](int tile) {
    const int nrows = min(a.rows, a.B - tile * a.rows);
    const uint32_t bytes = static_cast<uint32_t>(nrows) * n * sizeof(T);
    const int64_t off = static_cast<int64_t>(tile) * a.rows * n;
    repro::mbar_expect_tx(bar, 2 * bytes);
    bulk_load(lre, a.re + off, bytes, bar);
    bulk_load(lim, a.im + off, bytes, bar);
  };
  if constexpr (kBulk) {
    if (threadIdx.x == 0) {
      repro::mbar_init(bar, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      issue(blockIdx.x);
    }
    __syncthreads();
  }

  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++it) {
    const int valid = min(a.rows, a.B - tile * a.rows) << LOG2N;
    const int64_t off = static_cast<int64_t>(tile) * a.rows * n;
    if constexpr (kBulk) {
      repro::mbar_wait(bar, it & 1);
    } else {
      for (int e = threadIdx.x; e < valid; e += blockDim.x) {
        lre[e] = a.re[off + e];
        lim[e] = a.im[off + e];
      }
      __syncthreads();
    }
    float xr[kPoints], xi[kPoints];
    const Pass<LOG2N, 0, R0> first(valid);
    load_landed(xr, xi, first, lre, lim);
    // the first pass's reads are done: the landing planes take the next
    // tile. A warp may reach the barrier with its loads of them still in
    // flight; the proxy fence orders them before the async proxy's writes.
    if constexpr (kBulk) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if constexpr (kBulk) {
      if (threadIdx.x == 0 && tile + static_cast<int>(gridDim.x) < tiles) issue(tile + gridDim.x);
    }
    if constexpr (R0 == LOG2N) {
      butterflies_out(xr, xi, first, a.tw, a.ore + off, a.oim + off);
    } else {
      butterflies(xr, xi, first, a.tw);
      passes_from<LOG2N, 4>(xr, xi, valid, xs, a.tw, a.ore + off, a.oim + off);
    }
  }
}

// Rows per block for block_rows 0: the most, up to 8, within 4,096 elements.
int auto_rows(int n) {
  int rows = 1;
  while (rows < 8 && 2 * rows * n <= 4096) rows *= 2;
  return rows;
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  return sms;
}

template <typename T, int LOG2N, bool kBulk>
int launch_kernel(const Rows<T>& a, cudaStream_t st) {
  static bool raised[64] = {};
  auto kernel = fft_kernel<T, LOG2N, kBulk>;
  cudaError_t e = repro::raise_smem(kernel, smem_bytes(kMaxElems, sizeof(T)), raised);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int threads = std::max(32, a.cap / kPoints);
  const int smem = smem_bytes(a.cap, sizeof(T));
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int tiles = (a.B + a.rows - 1) / a.rows;
  const int grid = std::min(tiles, per_sm * sm_count());
  kernel<<<grid, threads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kBulk>
int launch_n(const Rows<T>& a, int log2n, cudaStream_t st) {
  switch (log2n) {
#define REPRO_FFT(L) \
  case L: return launch_kernel<T, L, kBulk>(a, st);
    REPRO_FFT(1) REPRO_FFT(2) REPRO_FFT(3) REPRO_FFT(4) REPRO_FFT(5) REPRO_FFT(6) REPRO_FFT(7)
    REPRO_FFT(8) REPRO_FFT(9) REPRO_FFT(10) REPRO_FFT(11) REPRO_FFT(12) REPRO_FFT(13)
    REPRO_FFT(14)
#undef REPRO_FFT
    default: return -1;
  }
}

template <typename T>
int launch(const void* re, const void* im, const float2* tw, void* ore, void* oim, int B, int N,
           int rows, cudaStream_t st) {
  int log2n = 0;
  while ((2 << log2n) <= N) ++log2n;
  if (N < 2 || (1 << log2n) != N || N > kMaxElems) return -1;
  if (rows == 0) rows = auto_rows(N);
  if ((rows != 1 && rows != 2 && rows != 4 && rows != 8) || rows * N > kMaxElems) return -1;
  if (B < 0) return -1;
  if (B == 0) return 0;
  const Rows<T> a{static_cast<const T*>(re), static_cast<const T*>(im), static_cast<T*>(ore),
                  static_cast<T*>(oim), tw, B, rows, rows * N};
  const bool bulk = (static_cast<size_t>(N) * sizeof(T)) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(re) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(im) % 16 == 0;
  return bulk ? launch_n<T, true>(a, log2n, st) : launch_n<T, false>(a, log2n, st);
}

// ------------------------------------------------ rows longer than a block

// out[b][c][r] = in[b][r][c] (times W_N^(r c) = exp(-2 pi i r c / N) when
// tw_n > 0) for planar in [B, R, C] and out [B, C, R]: the transposes (and
// the twiddle step) of the four-step FFT that fft.py composes around two
// batches of the row kernel for N > 16,384. A 32 x 32 tile passes through
// shared memory (padded a word per row), so both the read and the write
// are coalesced rows of 32; the twiddle's angle is reduced exactly as the
// integer (r c) mod N and taken in double (sincospi), then rounded to f32.
constexpr int kTile = 32, kTileRows = 8;

template <typename TI, typename TO, bool kTwiddle>
__global__ void __launch_bounds__(kTile * kTileRows)
transpose_kernel(const TI* __restrict__ re, const TI* __restrict__ im, TO* __restrict__ ore,
                 TO* __restrict__ oim, int B, int R, int C, int64_t tw_n) {
  __shared__ float tr[kTile][kTile + 1], ti[kTile][kTile + 1];
  const int c0 = blockIdx.x * kTile, r0 = blockIdx.y * kTile;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int b = blockIdx.z; b < B; b += gridDim.z) {
    const int64_t base = static_cast<int64_t>(b) * R * C;
#pragma unroll
    for (int i = ty; i < kTile; i += kTileRows) {
      const int r = r0 + i, c = c0 + tx;
      if (r < R && c < C) {
        float xr = repro::to_f32(re[base + static_cast<int64_t>(r) * C + c]);
        float xi = repro::to_f32(im[base + static_cast<int64_t>(r) * C + c]);
        if constexpr (kTwiddle) {
          const int64_t e = (static_cast<int64_t>(r) * c) % tw_n;
          double sn, cs;
          sincospi(-2.0 * static_cast<double>(e) / static_cast<double>(tw_n), &sn, &cs);
          const float wr = static_cast<float>(cs), wi = static_cast<float>(sn);
          const float yr = __fsub_rn(__fmul_rn(xr, wr), __fmul_rn(xi, wi));
          xi = __fadd_rn(__fmul_rn(xr, wi), __fmul_rn(xi, wr));
          xr = yr;
        }
        tr[i][tx] = xr;
        ti[i][tx] = xi;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = ty; i < kTile; i += kTileRows) {
      const int c = c0 + i, r = r0 + tx;
      if (r < R && c < C) {
        repro::store_f32(ore + base + static_cast<int64_t>(c) * R + r, tr[tx][i]);
        repro::store_f32(oim + base + static_cast<int64_t>(c) * R + r, ti[tx][i]);
      }
    }
    __syncthreads();  // the tile is free for the next batch row
  }
}

template <typename TI, typename TO, bool kTwiddle>
int launch_transpose(const void* re, const void* im, void* ore, void* oim, int B, int R, int C,
                     int64_t tw_n, cudaStream_t st) {
  const dim3 grid((C + kTile - 1) / kTile, (R + kTile - 1) / kTile, std::min(B, 65535));
  if (grid.y > 65535) return -1;
  transpose_kernel<TI, TO, kTwiddle><<<grid, dim3(kTile, kTileRows), 0, st>>>(
      static_cast<const TI*>(re), static_cast<const TI*>(im), static_cast<TO*>(ore),
      static_cast<TO*>(oim), B, R, C, tw_n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The four-step FFT's transposes: in re, im [B, R, C] of in_dtype, out ore,
// oim [B, C, R] of out_dtype (0 = float32, 1 = bfloat16), out[b][c][r] =
// in[b][r][c], times W_N^(r c) when tw_n = N > 0 (f32 to f32 only). Returns
// cudaGetLastError() after the launch, -1 for a shape the kernel does not
// take, -2 for an unsupported combination of dtypes.
extern "C" int repro_fft_transpose(const void* re, const void* im, void* ore, void* oim, int B,
                                   int R, int C, long long tw_n, int in_dtype, int out_dtype,
                                   void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 0 || R < 1 || C < 1 || tw_n < 0) return -1;
  if (B == 0) return 0;
  const bool f32_in = in_dtype == repro::kF32, f32_out = out_dtype == repro::kF32;
  if (tw_n > 0) {
    if (!f32_in || !f32_out) return -2;
    return launch_transpose<float, float, true>(re, im, ore, oim, B, R, C, tw_n, st);
  }
  if (f32_in && f32_out)
    return launch_transpose<float, float, false>(re, im, ore, oim, B, R, C, 0, st);
  if (in_dtype == repro::kBF16 && f32_out)
    return launch_transpose<__nv_bfloat16, float, false>(re, im, ore, oim, B, R, C, 0, st);
  if (f32_in && out_dtype == repro::kBF16)
    return launch_transpose<float, __nv_bfloat16, false>(re, im, ore, oim, B, R, C, 0, st);
  return -2;
}

// re, im, ore, oim: [B, N] contiguous of one dtype (0 = float32, 1 =
// bfloat16); tw: the f32 stage twiddles [N - 1, 2] (ref.fft_twiddle_stages,
// re and im interleaved). rows: rows per block, 1, 2, 4 or 8 with rows * N <=
// 16384, or 0 for the kernel's choice. Returns cudaGetLastError() after the
// launch, -1 for an N or rows the kernel does not take, -2 for an
// unsupported dtype.
extern "C" int repro_fft(const void* re, const void* im, const void* tw, void* ore, void* oim,
                         int B, int N, int rows, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float2* t = static_cast<const float2*>(tw);
  if (dtype == repro::kF32) return launch<float>(re, im, t, ore, oim, B, N, rows, st);
  if (dtype == repro::kBF16) return launch<__nv_bfloat16>(re, im, t, ore, oim, B, N, rows, st);
  return -2;
}
