// out = alpha * x + y, elementwise (the paper's LinAlg axpy).
//
// Replaces the TPU kernel repro/kernels/axpy.py::axpy (_axpy_kernel): x, y
// [R, C] of one type (f32 or bf16), out [R, C] in that type; alpha * x + y
// in f32, alpha already rounded to x's type by the caller (the TPU kernel's
// jnp.asarray(alpha, x.dtype)). One fused multiply-add, rounded once: what
// XLA makes of the TPU kernel's body when it runs on the CPU (interpret
// mode), and what the plain version computes in float64.
//
// What bounds it on the H100: the bytes — x and y read once, out written
// once (0.961 ms for 2^28 f32 elements at 3.35 TB/s).
//
// Simple design: the rows are contiguous, so the kernel streams the flat
// R * C elements (64-bit offsets) and the TPU grid (R, cdiv(C, block)) —
// whose second dimension passes CUDA's 65,535 limit of gridDim.y at the main
// shape — becomes chunks of `block` elements on gridDim.x, one chunk per
// block and grid-strided past 2^31 - 1 blocks. Each thread moves 16 bytes
// per load where the three pointers are 16-byte aligned and `block` is a
// multiple of the vector (a scalar tail at the end of the array), else one
// element at a time. block 0, the default, is the kernel's choice: one
// vector per thread, 256 vectors per block (1,024 f32 or 2,048 bf16
// elements), which kept the most loads in flight of the chunks measured on
// the H100 (PERF.md, the kernel table).

#include <algorithm>

#include "row_common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
axpy_kernel(float a, const T* __restrict__ x, const T* __restrict__ y, T* __restrict__ out,
            int64_t n, int64_t chunk) {
  for (int64_t base = blockIdx.x * chunk; base < n;
       base += static_cast<int64_t>(gridDim.x) * chunk) {
    const int64_t end = min(n, base + chunk);
    for (int64_t i = base + threadIdx.x * VEC; i < end; i += kThreads * VEC) {
      if (i + VEC <= end) {
        float xv[VEC], yv[VEC];
        repro::load_row<VEC>(x + i, xv);
        repro::load_row<VEC>(y + i, yv);
#pragma unroll
        for (int e = 0; e < VEC; ++e) xv[e] = __fmaf_rn(a, xv[e], yv[e]);
        repro::store_row<VEC>(out + i, xv);
      } else {
        for (int64_t j = i; j < end; ++j)
          repro::store_f32(out + j, __fmaf_rn(a, repro::to_f32(x[j]), repro::to_f32(y[j])));
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* y, void* out, float a, int R, int C, int block,
           cudaStream_t st) {
  constexpr int kVec = 16 / sizeof(T);
  const int64_t n = static_cast<int64_t>(R) * C;
  if (n == 0) return 0;
  const int64_t chunk = block > 0 ? block : kThreads * kVec;
  const int64_t blocks = (n + chunk - 1) / chunk;
  const dim3 grid(static_cast<unsigned>(std::min<int64_t>(blocks, INT32_MAX)));
  const bool vec = chunk % kVec == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const T* xp = static_cast<const T*>(x);
  const T* yp = static_cast<const T*>(y);
  T* op = static_cast<T*>(out);
  if (vec) {
    axpy_kernel<T, kVec><<<grid, kThreads, 0, st>>>(a, xp, yp, op, n, chunk);
  } else {
    axpy_kernel<T, 1><<<grid, kThreads, 0, st>>>(a, xp, yp, op, n, chunk);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y, out: [R, C] contiguous of one dtype (0 = float32, 1 = bfloat16).
// block: elements per CUDA block (> 0), or 0 for the kernel's choice.
// Returns cudaGetLastError() after the launch, -1 for a negative block, -2
// for an unsupported dtype.
extern "C" int repro_axpy(const void* x, const void* y, void* out, float alpha, int R, int C,
                          int block, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (block < 0) return -1;
  if (dtype == repro::kF32) return launch<float>(x, y, out, alpha, R, C, block, st);
  if (dtype == repro::kBF16) return launch<__nv_bfloat16>(x, y, out, alpha, R, C, block, st);
  return -2;
}
