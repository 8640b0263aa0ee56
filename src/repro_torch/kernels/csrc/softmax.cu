// Numerically stable softmax over the rows of a matrix.
//
// Replaces the TPU kernel repro/kernels/softmax.py::softmax (_softmax_kernel):
// x [R, C] (f32 or bf16), out [R, C] in x's type; out = exp(x - max) /
// sum(exp(x - max)) per row, all in f32.
//
// What bounds it on the H100: the bytes — each element is read once and
// written once (0.0071 ms at R = 64, C = 92,416 bf16 at 3.35 TB/s).
//
// Simple design (row_common.cuh): a group of 256 / ROWS threads per row. The
// first pass keeps an online (max, sum of exp) per thread — one exp per
// element, the sum rescaled when the max grows — merged over the group; the
// second re-reads the row (from L2: a 92,416-wide bf16 row is 185 KB) and
// writes exp(x - max) / sum. So any C runs without staging the row, where the
// TPU kernel needed the whole row in one VMEM block. The rows per CUDA block
// are the autotuner's knob (block_rows).

#include <cfloat>

#include "row_common.cuh"

namespace {

template <typename T, int ROWS, int VEC>
__global__ void __launch_bounds__(repro::kRowThreads)
softmax_kernel(const T* __restrict__ x, T* __restrict__ out, int R, int C) {
  constexpr int kGroup = repro::kRowThreads / ROWS;
  __shared__ float red_m[repro::kRowThreads / 32], red_s[repro::kRowThreads / 32];
  const int64_t row = static_cast<int64_t>(blockIdx.x) * ROWS + threadIdx.x / kGroup;
  const int t = threadIdx.x % kGroup;
  const bool live = row < R;
  const T* xr = x + row * C;
  T* orow = out + row * C;

  // a finite floor, so -inf inputs add exp(-inf) = 0 and never exp(-inf + inf)
  float m = -FLT_MAX, s = 0.f;
  if (live) {
    for (int c = t * VEC; c < C; c += kGroup * VEC) {
      float v[VEC];
      repro::load_row<VEC>(xr + c, v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        if (v[i] > m) {
          s = s * expf(m - v[i]) + 1.f;
          m = v[i];
        } else {
          s += expf(v[i] - m);
        }
      }
    }
  }
  repro::group_max_sum<ROWS>(m, s, red_m, red_s);
  if (!live) return;
  for (int c = t * VEC; c < C; c += kGroup * VEC) {
    float v[VEC];
    repro::load_row<VEC>(xr + c, v);
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = expf(v[i] - m) / s;
    repro::store_row<VEC>(orow + c, v);
  }
}

template <typename T, int ROWS>
int launch_rows(const void* x, void* out, int R, int C, bool vec, cudaStream_t st) {
  constexpr int kVec = 16 / sizeof(T);
  const dim3 grid((R + ROWS - 1) / ROWS);
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  if (vec) {
    softmax_kernel<T, ROWS, kVec><<<grid, repro::kRowThreads, 0, st>>>(xp, op, R, C);
  } else {
    softmax_kernel<T, ROWS, 1><<<grid, repro::kRowThreads, 0, st>>>(xp, op, R, C);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, void* out, int R, int C, int rows, cudaStream_t st) {
  const bool vec = C % (16 / sizeof(T)) == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  switch (rows != 0 ? rows : repro::auto_rows(R, C, vec ? 16 / sizeof(T) : 1)) {
    case 1: return launch_rows<T, 1>(x, out, R, C, vec, st);
    case 2: return launch_rows<T, 2>(x, out, R, C, vec, st);
    case 4: return launch_rows<T, 4>(x, out, R, C, vec, st);
    case 8: return launch_rows<T, 8>(x, out, R, C, vec, st);
    default: return -1;  // rows per block not instantiated
  }
}

}  // namespace

// dtype: the type of x and out (0 = float32, 1 = bfloat16). rows: rows per
// block, 1, 2, 4 or 8, or 0 to take repro::auto_rows' choice. Returns
// cudaGetLastError() after the launch, -1 for an unsupported rows, -2 for an
// unsupported dtype.
extern "C" int repro_softmax(const void* x, void* out, int R, int C, int rows, int dtype,
                             void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, out, R, C, rows, st);
  if (dtype == 1) return launch<__nv_bfloat16>(x, out, R, C, rows, st);
  return -2;
}
