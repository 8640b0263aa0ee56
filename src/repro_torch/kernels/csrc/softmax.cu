// Numerically stable softmax over the rows of a matrix.
//
// Replaces the TPU kernel repro/kernels/softmax.py::softmax (_softmax_kernel):
// x [R, C] (f32 or bf16), out [R, C] in x's type; out = exp(x - max) /
// sum(exp(x - max)) per row, all in f32.
//
// What bounds it on the H100: the bytes — each element is read once and
// written once (0.0071 ms at R = 64, C = 92,416 bf16 at 3.35 TB/s).
//
// Three bodies, chosen by the caller (kernels/softmax.py::route) and counted
// apart:
// - rows (C <= 256 / ROWS * 64): ROWS rows a block of 256 threads, a group
//   of 256 / ROWS threads a row (row_common.cuh's layout). Each thread loads
//   its chunks of the row once, 16-byte loads where rows and pointers allow,
//   and keeps them in registers (up to 64 elements); the group reduces the
//   max, then the sum of exp(x - max), and each thread writes exp(x - max) /
//   sum from the registers it holds: one read and one write an element, and
//   no per-element branch.
// - cluster (16,384 < C <= 131,072 at block_rows 0, the vocabulary's logits):
//   a row is cut into kCluster slices, one CTA of a thread-block cluster
//   each, so 64 rows of 92,416 fill the card with 512 CTAs where one block a
//   row left 68 of 132 SMs idle. A CTA reduces its slice, held in registers
//   as above, to (max m_r, sum s_r of exp(x - m_r)), publishes the pair in
//   its shared memory, and after cluster.sync() reads every rank's pair
//   through distributed shared memory and merges them in rank order (M = max
//   m_r, S = sum s_r exp(m_r - M)), so every CTA holds the same M and S; it
//   then writes its slice. The CTAs wait for each other once more before
//   they exit, so no CTA's shared memory goes while another still reads it.
//   ref.softmax_split is the plain twin.
// - wide (rows past a cluster's registers, or past a block's at a forced
//   block_rows): the two-pass body. A group of 256 / ROWS threads per row
//   keeps an online (max, sum of exp) per thread — one exp per element, the
//   sum rescaled when the max grows — merged over the group; the second pass
//   re-reads the row and writes exp(x - max) / sum.

#include <cooperative_groups.h>

#include <cfloat>

#include "row_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = repro::kRowThreads;
constexpr int kPerThread = 64;  // elements a thread holds in registers, at most
constexpr int kCluster = 8;     // CTAs (slices) of a row in the cluster body

enum Route { kRows = 0, kClusterRoute = 1, kWide = 2 };

// The max (kMax) or sum over a group of `group` threads (a multiple of 32
// dividing kThreads); every thread of the block calls it.
template <bool kMax>
__device__ __forceinline__ float group_reduce(float v, int group, float* red) {
  v = kMax ? repro::warp_max(v) : repro::warp_sum(v);
  if (group > 32) {
    const int warp = threadIdx.x >> 5, per = group >> 5, first = warp / per * per;
    if ((threadIdx.x & 31) == 0) red[warp] = v;
    __syncthreads();
    v = red[first];
    for (int w = 1; w < per; ++w) v = kMax ? fmaxf(v, red[first + w]) : v + red[first + w];
  }
  return v;
}

// The registers of CH chunks (4 a chunk) up to 32 leave room for four
// blocks an SM (64 registers a thread): 64 rows of 92,416 in clusters of 8
// are then one wave of 512 CTAs on 132 SMs, where the 123 registers ptxas
// takes uncapped leave two blocks an SM and two waves.
template <int CH>
constexpr int min_blocks() {
  return CH * 4 <= 32 ? 4 : 2;
}

// One row (or one cluster slice of a row) in registers: CH chunks of W =
// 16 / sizeof(T) elements a thread, chunk c = t + k * group of the
// columns [c0, c1). kVec: 16-byte loads and stores (C, c0 and the pointers
// 16-byte aligned); else element by element. kClusterBody: the slices of a
// row are the CTAs of a cluster of kCluster, merged through distributed
// shared memory.
template <typename T, int CH, bool kVec, bool kClusterBody>
__global__ void __launch_bounds__(kThreads, min_blocks<CH>())
softmax_reg_kernel(const T* __restrict__ x, T* __restrict__ out, int R, int C, int rows,
                   int slice) {
  constexpr int W = 16 / sizeof(T);
  __shared__ float red_m[kThreads / 32], red_s[kThreads / 32];
  __shared__ float pair[2], merged[2];
  const int group = kThreads / rows;
  int64_t row;
  int c0, c1;
  if constexpr (kClusterBody) {
    const int rank = static_cast<int>(cg::this_cluster().block_rank());
    row = blockIdx.x / kCluster;
    c0 = min(C, rank * slice);
    c1 = min(C, c0 + slice);
  } else {
    row = static_cast<int64_t>(blockIdx.x) * rows + threadIdx.x / group;
    c0 = 0;
    c1 = C;
  }
  const int t = threadIdx.x % group;
  const bool live = row < R;
  const T* xr = x + row * C;
  T* orow = out + row * C;

  repro::Vec<T, W> v[CH];
  // a finite floor, so -inf inputs add exp(-inf) = 0 and never exp(-inf + inf)
  float m = -FLT_MAX;
#pragma unroll
  for (int k = 0; k < CH; ++k) {
    const int c = c0 + (t + k * group) * W;
#pragma unroll
    for (int i = 0; i < W; ++i) v[k].v[i] = T(-INFINITY);
    if (!live || c >= c1) continue;
    if constexpr (kVec) {
      v[k] = *reinterpret_cast<const repro::Vec<T, W>*>(xr + c);
    } else {
#pragma unroll
      for (int i = 0; i < W; ++i)
        if (c + i < c1) v[k].v[i] = xr[c + i];
    }
#pragma unroll
    for (int i = 0; i < W; ++i) m = fmaxf(m, repro::to_f32(v[k].v[i]));
  }
  m = group_reduce<true>(m, group, red_m);
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < CH; ++k)
#pragma unroll
    for (int i = 0; i < W; ++i) s += expf(repro::to_f32(v[k].v[i]) - m);  // -inf pads add 0
  s = group_reduce<false>(s, group, red_s);

  if constexpr (kClusterBody) {
    cg::cluster_group cluster = cg::this_cluster();
    if (threadIdx.x == 0) {
      pair[0] = m;
      pair[1] = s;
    }
    cluster.sync();  // every rank's pair is published
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      float mr = -FLT_MAX, sr = 0.f;
      if (lane < kCluster) {
        const float* remote = cluster.map_shared_rank(pair, lane);
        mr = remote[0];
        sr = remote[1];
      }
      const float big = repro::warp_max(mr);
      const float term = sr * expf(mr - big);
      float total = 0.f;
#pragma unroll
      for (int r = 0; r < kCluster; ++r) total += __shfl_sync(0xffffffffu, term, r);  // rank order
      if (lane == 0) {
        merged[0] = big;
        merged[1] = total;
      }
    }
    // done reading the other ranks' shared memory; they may exit after the
    // wait below
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    __syncthreads();
    m = merged[0];
    s = merged[1];
  }

  if (live) {
#pragma unroll
    for (int k = 0; k < CH; ++k) {
      const int c = c0 + (t + k * group) * W;
      if (c >= c1) continue;
      float o[W];
#pragma unroll
      for (int i = 0; i < W; ++i) o[i] = expf(repro::to_f32(v[k].v[i]) - m) / s;
      if constexpr (kVec) {
        repro::store_row<W>(orow + c, o);
      } else {
#pragma unroll
        for (int i = 0; i < W; ++i)
          if (c + i < c1) repro::store_f32(orow + c + i, o[i]);
      }
    }
  }
  if constexpr (kClusterBody) asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The two-pass body (route wide).
template <typename T, int ROWS, int VEC>
__global__ void __launch_bounds__(kThreads)
softmax_kernel(const T* __restrict__ x, T* __restrict__ out, int R, int C) {
  constexpr int kGroup = kThreads / ROWS;
  __shared__ float red_m[kThreads / 32], red_s[kThreads / 32];
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
int launch_wide_rows(const void* x, void* out, int R, int C, bool vec, cudaStream_t st) {
  constexpr int kVec = 16 / sizeof(T);
  const dim3 grid((R + ROWS - 1) / ROWS);
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  if (vec) {
    softmax_kernel<T, ROWS, kVec><<<grid, kThreads, 0, st>>>(xp, op, R, C);
  } else {
    softmax_kernel<T, ROWS, 1><<<grid, kThreads, 0, st>>>(xp, op, R, C);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_wide(const void* x, void* out, int R, int C, int rows, bool vec, cudaStream_t st) {
  switch (rows) {
    case 1: return launch_wide_rows<T, 1>(x, out, R, C, vec, st);
    case 2: return launch_wide_rows<T, 2>(x, out, R, C, vec, st);
    case 4: return launch_wide_rows<T, 4>(x, out, R, C, vec, st);
    case 8: return launch_wide_rows<T, 8>(x, out, R, C, vec, st);
    default: return -1;  // rows per block not instantiated
  }
}

template <typename T, int CH, bool kVec>
int launch_reg_ch(const void* x, void* out, int R, int C, int rows, bool cluster, int slice,
                  cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  if (!cluster) {
    softmax_reg_kernel<T, CH, kVec, false>
        <<<(R + rows - 1) / rows, kThreads, 0, st>>>(xp, op, R, C, rows, 0);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(R) * kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, softmax_reg_kernel<T, CH, kVec, true>, xp, op, R, C, 1, slice);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// CH: the fewest chunks of those instantiated (1, 2, 4, 6, 8, 12, 16) that
// cover `chunks` over `group` threads, up to kPerThread / W.
template <typename T, bool kVec>
int launch_reg(const void* x, void* out, int R, int C, int rows, bool cluster, int slice,
               int chunks, cudaStream_t st) {
  constexpr int W = 16 / sizeof(T);
  const int group = kThreads / rows;
  const int need = (chunks + group - 1) / group;
#define REPRO_CH(N)                                                                       \
  if (need <= N) return launch_reg_ch<T, N, kVec>(x, out, R, C, rows, cluster, slice, st);
  REPRO_CH(1)
  REPRO_CH(2)
  REPRO_CH(4)
  REPRO_CH(6)
  REPRO_CH(8)
  if constexpr (kPerThread / W >= 16) {
    REPRO_CH(12)
    REPRO_CH(16)
  }
#undef REPRO_CH
  return -1;  // past the registers: route wide
}

template <typename T>
int launch(const void* x, void* out, int R, int C, int rows, int route, cudaStream_t st) {
  constexpr int W = 16 / sizeof(T);
  const bool vec = C % W == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (route == kWide) {
    if (rows == 0) rows = repro::auto_rows(R, C, vec ? W : 1);
    return launch_wide<T>(x, out, R, C, rows, vec, st);
  }
  const int chunks = (C + W - 1) / W;
  if (route == kClusterRoute) {
    if (rows != 0 && rows != 1) return -1;
    if (C > kCluster * kThreads * kPerThread || R > INT32_MAX / kCluster) return -1;
    const int slice = (chunks + kCluster - 1) / kCluster * W;  // a multiple of W
    const int per_cta = (slice + W - 1) / W;
    return vec ? launch_reg<T, true>(x, out, R, C, 1, true, slice, per_cta, st)
               : launch_reg<T, false>(x, out, R, C, 1, true, slice, per_cta, st);
  }
  if (route != kRows) return -1;
  if (rows == 0) rows = repro::auto_rows(R, C, W);
  if (rows != 1 && rows != 2 && rows != 4 && rows != 8) return -1;
  if (C > kThreads / rows * kPerThread) return -1;
  return vec ? launch_reg<T, true>(x, out, R, C, rows, false, 0, chunks, st)
             : launch_reg<T, false>(x, out, R, C, rows, false, 0, chunks, st);
}

}  // namespace

// dtype: the type of x and out (0 = float32, 1 = bfloat16). route: the body
// (0 rows, 1 cluster, 2 wide; kernels/softmax.py::route). rows: rows per
// block, 1, 2, 4 or 8, or 0 to take repro::auto_rows' choice (the cluster
// body takes 0 or 1). Returns cudaGetLastError() after the launch (the
// cluster launch's own error where it is refused), -1 for a rows, route or
// width the body does not take, -2 for an unsupported dtype.
extern "C" int repro_softmax(const void* x, void* out, int R, int C, int rows, int dtype,
                             int route, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32) return launch<float>(x, out, R, C, rows, route, st);
  if (dtype == repro::kBF16) return launch<__nv_bfloat16>(x, out, R, C, rows, route, st);
  return -2;
}
