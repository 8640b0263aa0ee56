// Partial dot products (the paper's LinAlg dotp).
//
// Replaces the TPU kernel repro/kernels/dotp.py::dotp_partials (_dotp_kernel):
// x, y [R, C] of one type (f32 or bf16); out [R, cdiv(C, block)] f32, where
// partial (r, j) is the f32 sum of x[r, c] * y[r, c] over c in
// [j * block, (j + 1) * block), the overhang of the last partial masked. The
// wrapper sums the partials (dotp), as the TPU package sums them outside its
// kernel.
//
// What bounds it on the H100: the bytes — x and y read once (0.641 ms for
// two 2^28-element f32 vectors at 3.35 TB/s).
//
// Simple design: one CUDA block of 256 threads per partial, on gridDim.x
// (grid-strided past 2^31 - 1 partials), any block and any C. Each thread
// accumulates its share of the partial's elements in f32 — 16 bytes per load
// where both pointers are 16-byte aligned and C and block are multiples of
// the vector, else one element at a time — and the block reduces the 256
// sums by warp shuffles and then the eight warp sums in shared memory, in a
// fixed order. The wrapper picks block when the caller leaves it 0.

#include "row_common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
dotp_kernel(const T* __restrict__ x, const T* __restrict__ y, float* __restrict__ out, int C,
            int block, int64_t partials, int nb) {
  __shared__ float red[kThreads / 32];
  for (int64_t p = blockIdx.x; p < partials; p += gridDim.x) {
    const int64_t row = p / nb;
    const int64_t start = (p - row * nb) * static_cast<int64_t>(block);
    const int64_t end = min(static_cast<int64_t>(C), start + block);
    const T* xr = x + row * C;
    const T* yr = y + row * C;
    float acc = 0.f;
    for (int64_t i = start + threadIdx.x * VEC; i < end; i += kThreads * VEC) {
      float xv[VEC], yv[VEC];
      repro::load_row<VEC>(xr + i, xv);
      repro::load_row<VEC>(yr + i, yv);
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc = fmaf(xv[e], yv[e], acc);
    }
    acc = repro::warp_sum(acc);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) s += red[w];
      out[p] = s;
    }
    __syncthreads();  // red is rewritten by the next partial
  }
}

template <typename T>
int launch(const void* x, const void* y, float* out, int R, int C, int block, cudaStream_t st) {
  constexpr int kVec = 16 / sizeof(T);
  const int nb = (C + block - 1) / block;
  const int64_t partials = static_cast<int64_t>(R) * nb;
  if (partials == 0) return 0;
  const dim3 grid(static_cast<unsigned>(partials < INT32_MAX ? partials : INT32_MAX));
  const bool vec = C % kVec == 0 && block % kVec == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const T* xp = static_cast<const T*>(x);
  const T* yp = static_cast<const T*>(y);
  if (vec) {
    dotp_kernel<T, kVec><<<grid, kThreads, 0, st>>>(xp, yp, out, C, block, partials, nb);
  } else {
    dotp_kernel<T, 1><<<grid, kThreads, 0, st>>>(xp, yp, out, C, block, partials, nb);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y: [R, C] contiguous of one dtype (0 = float32, 1 = bfloat16); out:
// [R, cdiv(C, block)] f32. Returns cudaGetLastError() after the launch, -1
// for a block below 1, -2 for an unsupported dtype.
extern "C" int repro_dotp(const void* x, const void* y, void* out, int R, int C, int block,
                          int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (block < 1) return -1;
  if (dtype == repro::kF32) return launch<float>(x, y, o, R, C, block, st);
  if (dtype == repro::kBF16) return launch<__nv_bfloat16>(x, y, o, R, C, block, st);
  return -2;
}
