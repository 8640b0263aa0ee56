// RMSNorm over the rows of a matrix.
//
// Replaces the TPU kernel repro/kernels/rmsnorm.py::rmsnorm (_rmsnorm_kernel):
// x [R, C] (f32 or bf16), w [C] (x's type or f32), out [R, C] in x's type;
// out = x * rsqrt(mean(x^2) + eps) * w, all in f32.
//
// What bounds it on the H100: the bytes — each element is read once and
// written once, with three flops between (0.010 ms at R = 2048, C = 4096 bf16
// at 3.35 TB/s).
//
// Simple design (row_common.cuh): a group of 256 / ROWS threads per row; the
// first pass sums the squares in f32 (group reduce), the second re-reads the
// row (L1/L2-resident: 8 KB at C = 4096 bf16) and writes x * inv * w. Any C
// and any R (the tail block's extra rows idle). The TPU kernel held a whole
// [block_rows, C] tile in VMEM; here block_rows is the rows per CUDA block,
// the autotuner's knob.

#include "row_common.cuh"

namespace {

template <typename T, typename TW, int ROWS, int VEC>
__global__ void __launch_bounds__(repro::kRowThreads)
rmsnorm_kernel(const T* __restrict__ x, const TW* __restrict__ w, T* __restrict__ out, int R,
               int C, float eps) {
  constexpr int kGroup = repro::kRowThreads / ROWS;
  __shared__ float red[repro::kRowThreads / 32];
  const int64_t row = static_cast<int64_t>(blockIdx.x) * ROWS + threadIdx.x / kGroup;
  const int t = threadIdx.x % kGroup;
  const bool live = row < R;
  const T* xr = x + row * C;
  T* orow = out + row * C;

  float ss = 0.f;
  if (live) {
    for (int c = t * VEC; c < C; c += kGroup * VEC) {
      float v[VEC];
      repro::load_row<VEC>(xr + c, v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) ss += v[i] * v[i];
    }
  }
  ss = repro::group_sum<ROWS>(ss, red);
  if (!live) return;
  const float inv = rsqrtf(ss / static_cast<float>(C) + eps);
  for (int c = t * VEC; c < C; c += kGroup * VEC) {
    float v[VEC], wv[VEC];
    repro::load_row<VEC>(xr + c, v);
    repro::load_row<VEC>(w + c, wv);
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = v[i] * inv * wv[i];
    repro::store_row<VEC>(orow + c, v);
  }
}

template <typename T, typename TW, int ROWS>
int launch_rows(const void* x, const void* w, void* out, int R, int C, float eps, bool vec,
                cudaStream_t st) {
  constexpr int kVec = 16 / sizeof(T);
  const dim3 grid((R + ROWS - 1) / ROWS);
  const T* xp = static_cast<const T*>(x);
  const TW* wp = static_cast<const TW*>(w);
  T* op = static_cast<T*>(out);
  if (vec) {
    rmsnorm_kernel<T, TW, ROWS, kVec><<<grid, repro::kRowThreads, 0, st>>>(xp, wp, op, R, C, eps);
  } else {
    rmsnorm_kernel<T, TW, ROWS, 1><<<grid, repro::kRowThreads, 0, st>>>(xp, wp, op, R, C, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename TW>
int launch(const void* x, const void* w, void* out, int R, int C, float eps, int rows,
           cudaStream_t st) {
  // 16-byte chunks when every row starts on a 16-byte boundary and the
  // pointers are aligned (the wrapper hands contiguous tensors)
  const bool vec = C % (16 / sizeof(T)) == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  switch (rows != 0 ? rows : repro::auto_rows(R, C, vec ? 16 / sizeof(T) : 1)) {
    case 1: return launch_rows<T, TW, 1>(x, w, out, R, C, eps, vec, st);
    case 2: return launch_rows<T, TW, 2>(x, w, out, R, C, eps, vec, st);
    case 4: return launch_rows<T, TW, 4>(x, w, out, R, C, eps, vec, st);
    case 8: return launch_rows<T, TW, 8>(x, w, out, R, C, eps, vec, st);
    default: return -1;  // rows per block not instantiated
  }
}

}  // namespace

// xdtype: the type of x and out, wdtype: the type of w (0 = float32, 1 =
// bfloat16; w is f32 or x's type). rows: rows per block, 1, 2, 4 or 8, or 0 to
// take repro::auto_rows' choice.
// Returns cudaGetLastError() after the launch, -1 for an unsupported rows,
// -2 for an unsupported dtype pair.
extern "C" int repro_rmsnorm(const void* x, const void* w, void* out, int R, int C, float eps,
                             int rows, int xdtype, int wdtype, void* stream) {
  using bf16 = __nv_bfloat16;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (xdtype == 0 && wdtype == 0) return launch<float, float>(x, w, out, R, C, eps, rows, st);
  if (xdtype == 1 && wdtype == 1) return launch<bf16, bf16>(x, w, out, R, C, eps, rows, st);
  if (xdtype == 1 && wdtype == 0) return launch<bf16, float>(x, w, out, R, C, eps, rows, st);
  return -2;
}
