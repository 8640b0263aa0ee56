// Shared device code of the row kernels (rmsnorm.cu, softmax.cu).
//
// Both take a row-major [R, C] matrix whose rows are independent. A block of
// kRowThreads threads holds ROWS rows (the autotuner's block_rows: 1, 2, 4 or
// 8, or 0 for auto_rows' choice from the shape), so each row has a group of
// kRowThreads / ROWS threads (a whole warp or more). A thread walks its row in VEC-element chunks, VEC * sizeof(T) = 16
// bytes where the host found every row and pointer 16-byte aligned (one
// vector load per chunk, neighbouring threads on neighbouring chunks), else
// one element at a time; the group's partial results meet through warp
// shuffles and, for groups wider than a warp, shared memory.
#pragma once

#include "attention_common.cuh"

namespace repro {

constexpr int kRowThreads = 256;

// Rows per block for block_rows 0, from the shape: double them while each
// thread's share of its row stays within 8 chunks of VEC elements and the
// grid keeps two blocks per SM or more. Wide rows (a vocabulary's logits)
// and few rows keep one row per block; many narrow rows (attention scores,
// d_model-wide activations) pack 4 or 8.
inline int auto_rows(int R, int C, int vec) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  const int64_t chunks = (C + vec - 1) / vec;
  int rows = 1;
  while (rows < 8 && chunks * 2 * rows <= 8 * kRowThreads &&
         (R + 2 * rows - 1) / (2 * rows) >= 2 * sms)
    rows *= 2;
  return rows;
}

// N elements of T, loaded or stored as one access of up to 16 bytes (two
// when N * sizeof(T) is 32: an f32 weight beside a bf16 row).
template <typename T, int N>
struct alignas(sizeof(T) * N < 16 ? sizeof(T) * N : 16) Vec {
  T v[N];
};

template <int N, typename T>
__device__ __forceinline__ void load_row(const T* __restrict__ p, float (&o)[N]) {
  const Vec<T, N> x = *reinterpret_cast<const Vec<T, N>*>(p);
#pragma unroll
  for (int i = 0; i < N; ++i) o[i] = to_f32(x.v[i]);
}

template <int N, typename T>
__device__ __forceinline__ void store_row(T* __restrict__ p, const float (&o)[N]) {
  Vec<T, N> x;
#pragma unroll
  for (int i = 0; i < N; ++i) store_f32(&x.v[i], o[i]);
  *reinterpret_cast<Vec<T, N>*>(p) = x;
}

// Sum over the group of kRowThreads / ROWS threads that shares a row; every
// thread of the block must call it (it may hold a barrier).
template <int ROWS>
__device__ __forceinline__ float group_sum(float x, float* red) {
  constexpr int kWarpsPerRow = kRowThreads / ROWS / 32;
  x = warp_sum(x);
  if constexpr (kWarpsPerRow > 1) {
    const int warp = threadIdx.x >> 5, first = warp / kWarpsPerRow * kWarpsPerRow;
    if ((threadIdx.x & 31) == 0) red[warp] = x;
    __syncthreads();
    x = 0.f;
#pragma unroll
    for (int w = 0; w < kWarpsPerRow; ++w) x += red[first + w];
  }
  return x;
}

// Two running (max m, sum s of exp(x - m)) states merged into one.
__device__ __forceinline__ void merge_max_sum(float& m, float& s, float m2, float s2) {
  const float mm = fmaxf(m, m2);
  s = s * expf(m - mm) + s2 * expf(m2 - mm);
  m = mm;
}

// The group's merged (max, sum of exp) state, as group_sum.
template <int ROWS>
__device__ __forceinline__ void group_max_sum(float& m, float& s, float* red_m, float* red_s) {
  constexpr int kWarpsPerRow = kRowThreads / ROWS / 32;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    merge_max_sum(m, s, __shfl_xor_sync(0xffffffffu, m, o), __shfl_xor_sync(0xffffffffu, s, o));
  if constexpr (kWarpsPerRow > 1) {
    const int warp = threadIdx.x >> 5, first = warp / kWarpsPerRow * kWarpsPerRow;
    if ((threadIdx.x & 31) == 0) {
      red_m[warp] = m;
      red_s[warp] = s;
    }
    __syncthreads();
    m = red_m[first];
    s = red_s[first];
#pragma unroll
    for (int w = 1; w < kWarpsPerRow; ++w) merge_max_sum(m, s, red_m[first + w], red_s[first + w]);
  }
}

}  // namespace repro
