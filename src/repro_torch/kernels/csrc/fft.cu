// Batched radix-2 Stockham FFT over the last dim, planar re/im (the paper's
// synchronisation-critical DSP kernel).
//
// Replaces the TPU kernel repro/kernels/fft.py::fft (_fft_kernel): re, im
// [B, N] of one type (f32 or bf16), N = 2^k from 2 to 16,384 in fft_kernel
// (longer rows: the four-step transposes at the end of this file around two
// batches of fft_kernel, composed by kernels/fft.py); out re, im
// [B, N] in that type; all math in f32. Stage s (L = 2^s) views each half of
// the row as [N / 2L, L], multiplies the second half by the stage's row of
// the twiddle table ([log2 N, N / 2] re and im, ref.fft_twiddles: the TPU
// kernel's table, read from global memory, where it stays in L2) and writes
// [e + t, e - t] side by side. The products and sums round as the plain
// Stockham version's separate operations do (__fmul_rn, no contraction).
// Row s of the table repeats with period L (entry p is W_2L^(p mod L)), so a
// stage stages its L distinct entries in shared memory with one coalesced
// load, and its butterflies read them there: read pair by pair from L2, the
// twiddles left a 16-pair thread waiting on one L2 round trip per pair.
//
// What bounds it on the H100: the bytes — each row read once and written
// once (0.641 ms at B = 8192, N = 16,384 f32 at 3.35 TB/s); 5 N log2 N
// flops per row are a fifth of that at the f32 rate.
//
// Simple design, the TPU kernel's point kept: a CUDA block holds `rows`
// whole rows in shared memory through all log2 N stages, so no stage goes
// back to global memory. A ping-pong pair of planar f32 rows would take 16 N
// bytes — 256 KiB at N = 16,384, more than a block may have — so each stage
// runs in place: every thread reads its butterfly pairs into registers, the
// block synchronises, every thread writes its two outputs per pair, and the
// block synchronises again. That keeps 8 N bytes per row (128 KiB at N =
// 16,384, dynamic shared memory above 48 KB), beside 4 N bytes for a
// stage's twiddles. Up to 512 threads (1,024 at N = 16,384), each owning
// PP = rows * N / 2 / threads pairs (at most 8, in registers). rows * N may not pass 16,384; `rows` is
// the autotuner's knob (block_rows: 1, 2, 4 or 8, or 0 for the kernel's
// choice, the most rows up to 8 within 4,096 elements).

#include <algorithm>

#include "row_common.cuh"

namespace {

constexpr int kMaxElems = 16384;  // rows * N of one block: 128 KiB of f32 re and im
// shared memory of a block: its rows' re and im, and a stage's twiddles (N / 2 re and im)
__host__ __device__ constexpr size_t smem_bytes(int rows, int n) {
  return sizeof(float) * (2 * static_cast<size_t>(rows) * n + n);
}
constexpr int kMaxThreads = 1024;

template <typename T, int PP, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
fft_kernel(const T* __restrict__ re, const T* __restrict__ im, const float* __restrict__ twr,
           const float* __restrict__ twi, T* __restrict__ ore, T* __restrict__ oim, int B,
           int log2n, int rows) {
  extern __shared__ __align__(16) float smem[];
  const int n = 1 << log2n, half = n >> 1;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * rows;
  const int nrows = static_cast<int>(min(static_cast<int64_t>(rows), B - row0));
  const int total = nrows * n;
  float* sr = smem;
  float* si = smem + rows * n;
  float* swr = si + rows * n;  // the stage's L distinct twiddles
  float* swi = swr + half;
  const int64_t off = row0 * n;

#pragma unroll 4
  for (int i = threadIdx.x * VEC; i < total; i += blockDim.x * VEC) {
    float v[VEC];
    repro::load_row<VEC>(re + off + i, v);
#pragma unroll
    for (int e = 0; e < VEC; ++e) sr[i + e] = v[e];
    repro::load_row<VEC>(im + off + i, v);
#pragma unroll
    for (int e = 0; e < VEC; ++e) si[i + e] = v[e];
  }
  __syncthreads();

  const int pairs = nrows * half;
  for (int s = 0; s < log2n; ++s) {
    const int L = 1 << s;
    for (int j = threadIdx.x; j < L; j += blockDim.x) {
      swr[j] = __ldg(twr + static_cast<int64_t>(s) * half + j);
      swi[j] = __ldg(twi + static_cast<int64_t>(s) * half + j);
    }
    __syncthreads();  // the stage's twiddles are in place
    float ar[PP], ai[PP], br[PP], bi[PP];
#pragma unroll
    for (int k = 0; k < PP; ++k) {
      const int q = threadIdx.x + k * blockDim.x;
      if (q >= pairs) continue;
      const int base = (q >> (log2n - 1)) << log2n, p = q & (half - 1);
      const float er = sr[base + p], ei = si[base + p];
      const float orr = sr[base + half + p], oi = si[base + half + p];
      const float wr = swr[p & (L - 1)], wi = swi[p & (L - 1)];
      const float t_r = __fsub_rn(__fmul_rn(orr, wr), __fmul_rn(oi, wi));
      const float t_i = __fadd_rn(__fmul_rn(orr, wi), __fmul_rn(oi, wr));
      ar[k] = er + t_r;
      ai[k] = ei + t_i;
      br[k] = er - t_r;
      bi[k] = ei - t_i;
    }
    __syncthreads();  // every pair is in registers: the stage may overwrite the rows
#pragma unroll
    for (int k = 0; k < PP; ++k) {
      const int q = threadIdx.x + k * blockDim.x;
      if (q >= pairs) continue;
      const int base = (q >> (log2n - 1)) << log2n, p = q & (half - 1);
      // pair p = g * L + j lands at g * 2L + j (e + t) and L further (e - t)
      const int o = base + 2 * p - (p & (L - 1));
      sr[o] = ar[k];
      si[o] = ai[k];
      sr[o + L] = br[k];
      si[o + L] = bi[k];
    }
    __syncthreads();  // the rows and the twiddle slots are free for the next stage
  }

#pragma unroll 4
  for (int i = threadIdx.x * VEC; i < total; i += blockDim.x * VEC) {
    float v[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) v[e] = sr[i + e];
    repro::store_row<VEC>(ore + off + i, v);
#pragma unroll
    for (int e = 0; e < VEC; ++e) v[e] = si[i + e];
    repro::store_row<VEC>(oim + off + i, v);
  }
}

// Rows per block for block_rows 0: the most, up to 8, within 4,096 elements.
int auto_rows(int n) {
  int rows = 1;
  while (rows < 8 && 2 * rows * n <= 4096) rows *= 2;
  return rows;
}

template <typename T, int PP, int VEC>
int launch_pp(const void* re, const void* im, const float* twr, const float* twi, void* ore,
              void* oim, int B, int log2n, int rows, int threads, cudaStream_t st) {
  const size_t smem = smem_bytes(rows, 1 << log2n);
  auto kernel = fft_kernel<T, PP, VEC>;
  static bool raised[64] = {};  // the attribute, once per instantiation and device
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 64 || !raised[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem_bytes(1, kMaxElems)));
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < 64) raised[dev] = true;
  }
  const dim3 grid((B + rows - 1) / rows);
  kernel<<<grid, threads, smem, st>>>(static_cast<const T*>(re), static_cast<const T*>(im), twr,
                                      twi, static_cast<T*>(ore), static_cast<T*>(oim), B, log2n,
                                      rows);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
int launch_vec(const void* re, const void* im, const float* twr, const float* twi, void* ore,
               void* oim, int B, int log2n, int rows, cudaStream_t st) {
  const int pairs = (rows << log2n) / 2;  // a power of two, 1 .. kMaxElems / 2
  // 512 threads or fewer, each with up to 8 pairs; 1,024 only where 512
  // would need 16 (N = 16,384), which spilled at 512 threads' 128 registers
  const int threads = std::max({32, std::min(512, pairs), pairs / 8});
  switch (std::max(1, pairs / threads)) {
#define REPRO_FFT(PP) \
  case PP: return launch_pp<T, PP, VEC>(re, im, twr, twi, ore, oim, B, log2n, rows, threads, st);
    REPRO_FFT(1)
    REPRO_FFT(2)
    REPRO_FFT(4)
    REPRO_FFT(8)
#undef REPRO_FFT
    default: return -1;
  }
}

template <typename T>
int launch(const void* re, const void* im, const float* twr, const float* twi, void* ore,
           void* oim, int B, int N, int rows, cudaStream_t st) {
  int log2n = 0;
  while ((2 << log2n) <= N) ++log2n;
  if (N < 2 || (1 << log2n) != N || N > kMaxElems) return -1;
  if (rows == 0) rows = auto_rows(N);
  if ((rows != 1 && rows != 2 && rows != 4 && rows != 8) || rows * N > kMaxElems) return -1;
  if (B == 0) return 0;
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = N % kVec == 0 &&
                   reinterpret_cast<uintptr_t>(re) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(im) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(ore) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(oim) % 16 == 0;
  if (vec) return launch_vec<T, kVec>(re, im, twr, twi, ore, oim, B, log2n, rows, st);
  return launch_vec<T, 1>(re, im, twr, twi, ore, oim, B, log2n, rows, st);
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
// bfloat16); twr, twi: the f32 twiddle table [log2 N, N / 2]. rows: rows per
// block, 1, 2, 4 or 8 with rows * N <= 16384, or 0 for the kernel's choice.
// Returns cudaGetLastError() after the launch, -1 for an N or rows the
// kernel does not take, -2 for an unsupported dtype.
extern "C" int repro_fft(const void* re, const void* im, const void* twr, const void* twi,
                         void* ore, void* oim, int B, int N, int rows, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* tr = static_cast<const float*>(twr);
  const float* ti = static_cast<const float*>(twi);
  if (dtype == repro::kF32) return launch<float>(re, im, tr, ti, ore, oim, B, N, rows, st);
  if (dtype == repro::kBF16)
    return launch<__nv_bfloat16>(re, im, tr, ti, ore, oim, B, N, rows, st);
  return -2;
}
