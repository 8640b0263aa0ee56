// Flash attention: flat and GQA prefill, causal or not.
//
// Replaces the TPU kernels repro/kernels/flash_attention.py::flash_attention
// (_flash_kernel) and ::gqa_flash_attention (_gqa_flash_kernel), both over
// _flash_tile_body and _online_softmax_update: q [BKV, G, Sq, D], k/v
// [BKV, Sk, D]; query i sees key j iff j < Sk (the kv_len tail mask) and,
// when causal, j <= i (top-left aligned, also when Sq != Sk). Returns
// [BKV, G, Sq, D]. The flat op is G = 1 with one grid row per (batch, head).
// D is 16, 32, 64, 80 or 128.
//
// What bounds it on the H100: at the prompt lengths the engine prefills
// (buckets up to the prefill budget, 64 tokens by default) the bytes of q, k,
// v and out; for long prompts (the kernel API's S = 1024) the 4 * Sq * Sk / 2
// * D flops per head, which only tensor cores (wgmma) can deliver at the
// card's rate.
//
// bf16: wgmma on Hopper's tensor cores (flash_wgmma_kernel). A block holds
// BQ = 64 or 128 rows of the [G * Sq, D] query matrix of one KV head (the G
// heads of the group packed into M, row g * Sq + i at position i), so every
// K/V tile is loaded once for the whole group and a short prefill still
// fills the 64-row tile. Each 64 rows are one consumer warpgroup:
// - S = Q K^T with wgmma m64nBKk16 (bf16 in, f32 accumulate), Q and the
//   K tile read from shared memory through K-major descriptors;
// - the online softmax runs on the accumulator fragments in registers
//   (exp2 with log2(e) folded into the scale); a row's max and sum reduce
//   over the four threads that share it, the sum only once at the end;
// - P is rounded to bf16 in registers, where the accumulator's layout is
//   already the A-operand layout of O += P V (wgmma m64nDk16, A from
//   registers), and the V tile is read through a transposed (MN-major)
//   descriptor. O stays in f32 registers; 1/l is applied at the end.
// Q and the K/V tiles sit in shared memory in the 128-byte-swizzled layout
// the descriptors name (rows of 64 columns; D = 80 and 128 take two such
// column blocks, D = 16 and 32 one, partly used). A producer warp loads them
// with TMA (3-D tensor maps [heads][rows][D], boxes of 64 columns, zero-
// filled past Sk, the group's rows or D) into rings of two K and two V
// stages; mbarriers count each stage's bytes in (full) and the consumers'
// reads out (empty), so later tiles land while one is computed and no block
// barrier runs in the key loop. Within a warpgroup the loop is software-
// pipelined: tile k's S = Q K^T and tile k - 1's O += P V are issued
// together, the softmax of tile k runs once S is done while P V still
// occupies the tensor cores, and a K stage is released as soon as its S is
// read. With causal, the key loop stops at the
// block's last query position and only tiles that cross the diagonal or
// the Sk tail are masked; the causal blocks with the most tiles start first.
// The tile (block_q, block_k) = (BQ, BK) is the autotuner's knob: (64, 64),
// (64, 128), (128, 64) or (128, 128); (64, 64) is the serving default.
//
// f32: CUDA cores (flash_kernel): wgmma would read f32 as TF32, whose ten
// mantissa bits the f32 tolerances do not allow. One block per (B*KV row,
// query head g, BQ-row Q tile), the TPU grid's K axis a loop inside the
// block that stops at the causal diagonal. Each BK-key K/V tile is staged
// in shared memory (rows padded by one word so the per-lane dot products hit
// distinct banks); each warp owns 4 query rows, lane c scores keys c, c +
// 32, ... of the tile, and the online softmax runs in f32 registers. Lane c
// owns output columns c, c + 32, ... (lanes past D idle in P.V at D = 16 and
// 80). Tiles: (16, 32), (32, 32), (32, 64) and (64, 64), the serving default;
// tiles above the 48 KB of static shared memory take dynamic shared memory.
// Ping-pong consumer warpgroups and persistent blocks are later work.

#include <cuda.h>

#include <climits>

#include "attention_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ------------------------------------------------------ f32: CUDA cores

constexpr int kRowsPerWarp = 4;

template <int D, int BQ, int BK>
struct Tiles {
  float q[BQ][D];
  float k[BK][D + 1];
  float v[BK][D + 1];
};

// Static shared memory where the tiles fit its 48 KB, dynamic shared memory
// above: with dynamic shared memory the (16, 32) tile ran 13% slower at the
// engine's 64-token prefill (0.0184 against 0.0163 ms,
// scripts/torch_attention_ab.py, H100 SXM).
template <int D, int BQ, int BK>
constexpr bool kStaticTiles = sizeof(Tiles<D, BQ, BK>) <= 48 * 1024;

template <int D, int BQ, int BK>
__device__ __forceinline__ Tiles<D, BQ, BK>& tiles() {
  if constexpr (kStaticTiles<D, BQ, BK>) {
    __shared__ Tiles<D, BQ, BK> t;
    return t;
  } else {
    extern __shared__ float4 dyn[];
    return *reinterpret_cast<Tiles<D, BQ, BK>*>(dyn);
  }
}

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(BQ / kRowsPerWarp * 32)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ out, int G, int Sq, int Sk, int causal) {
  constexpr int kThreads = BQ / kRowsPerWarp * 32;
  constexpr int NK = BK / 32;         // keys per lane per tile
  constexpr int NC = (D + 31) / 32;   // output columns per lane
  Tiles<D, BQ, BK>& t = tiles<D, BQ, BK>();
  auto& qs = t.q;
  auto& ks = t.k;
  auto& vs = t.v;

  const int bkv = blockIdx.x, g = blockIdx.y, q0 = blockIdx.z * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t qo_base = ((static_cast<int64_t>(bkv) * G + g) * Sq) * D;
  const T* kb = k + static_cast<int64_t>(bkv) * Sk * D;
  const T* vb = v + static_cast<int64_t>(bkv) * Sk * D;
  const float scale = rsqrtf(static_cast<float>(D));

  for (int idx = threadIdx.x; idx < BQ * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    qs[r][c] = q0 + r < Sq ? repro::to_f32(q[qo_base + static_cast<int64_t>(q0 + r) * D + c]) : 0.f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][NC];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = repro::kNegInf;
    l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < NC; ++i) acc[rr][i] = 0.f;
  }

  // keys past the last query row of this tile are masked for every row
  const int k_end = causal ? min(Sk, q0 + BQ) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile is consumed (and qs is written)
    for (int idx = threadIdx.x; idx < BK * D; idx += kThreads) {
      const int r = idx / D, c = idx % D;
      const bool ok = k0 + r < Sk;
      const int64_t off = static_cast<int64_t>(k0 + r) * D + c;
      ks[r][c] = ok ? repro::to_f32(kb[off]) : 0.f;
      vs[r][c] = ok ? repro::to_f32(vb[off]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      float s[NK];
#pragma unroll
      for (int j = 0; j < NK; ++j) s[j] = 0.f;
#pragma unroll 16
      for (int c = 0; c < D; ++c) {
        const float qc = qs[r][c];
#pragma unroll
        for (int j = 0; j < NK; ++j) s[j] += qc * ks[lane + 32 * j][c];
      }
      float tile_max = repro::kNegInf;
      bool valid[NK];
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        const int key = k0 + lane + 32 * j;
        s[j] *= scale;
        valid[j] = key < Sk && (!causal || key <= q0 + r);
        if (valid[j]) tile_max = fmaxf(tile_max, s[j]);
      }
      const float m_new = fmaxf(m[rr], repro::warp_max(tile_max));
      float p[NK], p_sum = 0.f;
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        p[j] = valid[j] ? expf(s[j] - m_new) : 0.f;
        p_sum += p[j];
      }
      const float corr = expf(m[rr] - m_new);
      l[rr] = l[rr] * corr + repro::warp_sum(p_sum);
#pragma unroll
      for (int i = 0; i < NC; ++i) acc[rr][i] *= corr;
#pragma unroll
      for (int j = 0; j < NK; ++j) {
#pragma unroll 8
        for (int c = 0; c < 32; ++c) {
          const float pc = __shfl_sync(0xffffffffu, p[j], c);
#pragma unroll
          for (int i = 0; i < NC; ++i)
            if (D % 32 == 0 || lane + 32 * i < D) acc[rr][i] += pc * vs[32 * j + c][lane + 32 * i];
        }
      }
      m[rr] = m_new;
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int row = q0 + warp * kRowsPerWarp + rr;
    if (row >= Sq) continue;
    const float inv = 1.f / fmaxf(l[rr], 1e-30f);
#pragma unroll
    for (int i = 0; i < NC; ++i)
      if (D % 32 == 0 || lane + 32 * i < D)
        repro::store_f32(out + qo_base + static_cast<int64_t>(row) * D + lane + 32 * i,
                         acc[rr][i] * inv);
  }
}

template <typename T, int D, int BQ, int BK>
int launch_tile(const void* q, const void* k, const void* v, void* out, int BKV, int G, int Sq,
                int Sk, int causal, cudaStream_t stream) {
  constexpr int kSmem = kStaticTiles<D, BQ, BK> ? 0 : sizeof(Tiles<D, BQ, BK>);
  auto kernel = flash_kernel<T, D, BQ, BK>;
  if (kSmem > 0) {
    // once per device and instantiation, outside any stream capture that
    // starts after the first call
    static bool raised[64] = {};
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev >= 64 || !raised[dev]) {
      const cudaError_t err =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
      if (err != cudaSuccess) return static_cast<int>(err);
      if (dev < 64) raised[dev] = true;
    }
  }
  const dim3 grid(BKV, G, (Sq + BQ - 1) / BQ);
  kernel<<<grid, BQ / kRowsPerWarp * 32, kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), G, Sq, Sk, causal);
  return static_cast<int>(cudaGetLastError());
}


// ------------------------------------------------------- bf16: wgmma

// d[32] (+)= A (64 x 16, shared, K-major) * B (16 x 64, shared, K-major)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d[64] (+)= A (64 x 16, shared, K-major) * B (16 x 128, shared, K-major)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d[8] += A (64 x 16, registers) * B (16 x 16, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[16] += A (64 x 16, registers) * B (16 x 32, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[32] += A (64 x 16, registers) * B (16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[40] += A (64 x 16, registers) * B (16 x 80, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n80(float (&d)[40], const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[64] += A (64 x 16, registers) * B (16 x 128, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed wgmma groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads of an accumulator across the wait,
// and an A operand's registers live (unreused) until the wgmma reading them
// has retired.
template <int N>
__device__ __forceinline__ void fence_operand(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_operand(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// A wgmma shared-memory descriptor of the 128-byte swizzle (layout type 1):
// the start address, the leading and the stride byte offsets, each in
// 16-byte units. K-major tiles (Q, K): SBO = 1024, the 8-row groups; LBO is
// unused. MN-major tiles (V): LBO = the stride of the 64-column blocks,
// SBO = 1024, the 8-key groups.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int scale_d) {
  if constexpr (N == 64) wgmma_ss_n64(d, a, b, scale_d);
  else wgmma_ss_n128(d, a, b, scale_d);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (N == 16) wgmma_rs_n16(d, a, b);
  else if constexpr (N == 32) wgmma_rs_n32(d, a, b);
  else if constexpr (N == 64) wgmma_rs_n64(d, a, b);
  else if constexpr (N == 80) wgmma_rs_n80(d, a, b);
  else wgmma_rs_n128(d, a, b);
}

// mbarriers (shared-memory barriers that count arrivals and, for TMA, bytes)
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// Waits until the barrier's phase `parity` has completed. A wait that
// outlasts ~2^32 cycles (seconds) traps: a lost arrival fails the launch
// instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_addr(bar);
  const long long t0 = clock64();
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 32)) __trap();
  }
}
// One TMA box of a 3-D tensor map ([heads][rows][columns]) into shared
// memory, counted on `bar` in bytes.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int col,
                                         int row, int head) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(col), "r"(row), "r"(head)
      : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <int D, int BQ, int BK>
struct WgTiles {
  static constexpr int kBlocks = (D + 63) / 64;  // 64-column blocks of a row
  static constexpr int kQ = kBlocks * BQ * 128;  // bytes of the Q tile
  static constexpr int kKV = kBlocks * BK * 128;  // bytes of one K or V stage
  static constexpr int kStages = 2;
  // Q, the K ring, the V ring, the barriers, and room to align the base to
  // 1024 bytes (the 128-byte swizzle's atom)
  static constexpr int kBytes = kQ + 2 * kStages * kKV + 1024 + 1024;
  static constexpr int kConsumers = BQ * 2;  // one warpgroup of 128 threads per 64 rows
  static constexpr int kThreads = kConsumers + 32;  // and one producer warp
};

// The tensor maps of q [BKV, M, D], k and v [BKV, Sk, D]: boxes of 64
// columns x BQ (q) or BK (k, v) rows of one head, 128-byte swizzled as the
// wgmma descriptors read them, zero-filled past the rows or columns.
struct Maps {
  CUtensorMap q, k, v;
};

template <int D, int BQ, int BK>
__global__ void __launch_bounds__(WgTiles<D, BQ, BK>::kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ Maps maps, bf16* __restrict__ out, int G, int Sq,
                   int Sk, int causal) {
  using Tl = WgTiles<D, BQ, BK>;
  constexpr int kS = Tl::kStages;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* sq = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* sk = sq + Tl::kQ;
  uint8_t* sv = sk + kS * Tl::kKV;
  // per stage: K landed, V landed, K read by every consumer, V read likewise
  uint64_t* full_k = reinterpret_cast<uint64_t*>(sv + kS * Tl::kKV);
  uint64_t* full_v = full_k + kS;
  uint64_t* empty_k = full_v + kS;
  uint64_t* empty_v = empty_k + kS;
  uint64_t* q_full = empty_v + kS;

  const int tid = threadIdx.x;
  const int M = G * Sq;  // the group's query rows, g * Sq + i
  const int m0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // the most key tiles first
  const int m_hi = min(m0 + BQ, M) - 1;
  const bool wraps = m0 / Sq != m_hi / Sq;
  const int min_i = wraps ? 0 : m0 % Sq, max_i = wraps ? Sq - 1 : m_hi % Sq;
  const int k_end = causal ? min(Sk, max_i + 1) : Sk;
  const int n_tiles = (k_end + BK - 1) / BK;
  const int bkv = blockIdx.y;

  if (tid == 0) {
    for (int s = 0; s < kS; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_k[s], Tl::kConsumers);
      mbar_init(&empty_v[s], Tl::kConsumers);
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= Tl::kConsumers) {
    // the producer warp: one lane keeps the K and V rings full with TMA loads
    if (tid == Tl::kConsumers) {
      mbar_expect_tx(q_full, Tl::kQ);
      for (int b = 0; b < Tl::kBlocks; ++b)
        tma_load(sq + b * BQ * 128, &maps.q, q_full, 64 * b, m0, bkv);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % kS, round = ((it / kS) & 1) ^ 1;  // the first round passes
        mbar_wait(&empty_k[st], round);
        mbar_expect_tx(&full_k[st], Tl::kKV);
        for (int b = 0; b < Tl::kBlocks; ++b)
          tma_load(sk + st * Tl::kKV + b * BK * 128, &maps.k, &full_k[st], 64 * b, it * BK, bkv);
        mbar_wait(&empty_v[st], round);
        mbar_expect_tx(&full_v[st], Tl::kKV);
        for (int b = 0; b < Tl::kBlocks; ++b)
          tma_load(sv + st * Tl::kKV + b * BK * 128, &maps.v, &full_v[st], 64 * b, it * BK, bkv);
      }
    }
    return;
  }

  // the consumers: warpgroup wg owns rows wg * 64 .. wg * 64 + 63 of the
  // tile. This thread's two rows (the accumulator layout: warp w holds rows
  // 16w .. 16w + 15, lane l rows l / 4 and l / 4 + 8, and columns
  // 8j + 2 (l % 4) + {0, 1} of every 8-column block j)
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int r0 = wg * 64 + warp * 16 + (lane >> 2);
  const int pos[2] = {(m0 + r0) % Sq, (m0 + r0 + 8) % Sq};
  const int col = 2 * (lane & 3);
  const float scale = rsqrtf(static_cast<float>(D)) * 1.4426950408889634f;  // log2(e) / sqrt(D)

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  float s[BK / 2];
  uint32_t pa[BK / 16][4];

  // S = Q K^T of tile it, issued (not waited for)
  auto issue_s = [&](int it) {
    const uint8_t* kt = sk + (it % kS) * Tl::kKV;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int koff = (kk & 3) * 32;  // the 16-column step inside column block kk / 4
      const uint64_t da = smem_desc(sq + (kk >> 2) * BQ * 128 + wg * 64 * 128 + koff, 16, 1024);
      const uint64_t db = smem_desc(kt + (kk >> 2) * BK * 128 + koff, 16, 1024);
      wgmma_ss<BK>(s, da, db, kk > 0);
    }
    wgmma_commit();
  };
  // O += P V of tile it, P from `p` (registers), issued (not waited for)
  auto issue_pv = [&](int it, const uint32_t (&p)[BK / 16][4]) {
    const uint8_t* vt = sv + (it % kS) * Tl::kKV;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs<D>(o, p[kk], smem_desc(vt + kk * 16 * 128, BK * 128, 1024));
    wgmma_commit();
  };
  // the online softmax of tile it's scores s: the running max and sum move
  // on, P goes to `p` as bf16 A fragments, corr is O's rescale
  auto softmax = [&](int it, uint32_t (&p)[BK / 16][4], float (&corr)[2]) {
    const int k0 = it * BK;
    const bool masked = k0 + BK > Sk || (causal && k0 + BK - 1 > min_i);
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * j + 2 * h + e];
          x *= scale;
          if (masked) {
            const int key = k0 + 8 * j + col + e;
            if (key >= Sk || (causal && key > pos[h])) x = -INFINITY;
          }
          mx[h] = fmaxf(mx[h], x);
        }
      }
    }
    float base[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      base[h] = mx[h] == -INFINITY ? 0.f : mx[h];  // a row with no key yet
      corr[h] = exp2f(m_run[h] - base[h]);
      m_run[h] = mx[h];
      l_run[h] *= corr[h];
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float p0 = exp2f(s[4 * j + 2 * h] - base[h]);
        const float p1 = exp2f(s[4 * j + 2 * h + 1] - base[h]);
        l_run[h] += p0 + p1;
        // column block j is half (j % 2) of the 16-key step j / 2: registers
        // 0 and 1 (rows r, r + 8) of its first 8 keys, 2 and 3 of its second
        p[j >> 1][(j & 1) * 2 + h] = pack_bf16(p0, p1);
      }
    }
  };
  auto rescale = [&](const float (&corr)[2]) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j] *= corr[0];
      o[4 * j + 1] *= corr[0];
      o[4 * j + 2] *= corr[1];
      o[4 * j + 3] *= corr[1];
    }
  };

  // The key loop, software-pipelined within the warpgroup: tile it's S =
  // Q K^T and tile it - 1's O += P V run on the tensor cores while this
  // thread's softmax of tile it waits only for the first; O is rescaled
  // once the second is done. A K stage is released when its S is read, a V
  // stage when its P V is.
  float corr[2];
  mbar_wait(q_full, 0);
  mbar_wait(&full_k[0], 0);
  issue_s(0);
  wgmma_wait<0>();
  fence_operand(s);
  mbar_arrive(&empty_k[0]);
  softmax(0, pa, corr);
  for (int it = 1; it < n_tiles; ++it) {
    mbar_wait(&full_k[it % kS], (it / kS) & 1);
    issue_s(it);
    mbar_wait(&full_v[(it - 1) % kS], ((it - 1) / kS) & 1);
    issue_pv(it - 1, pa);
    wgmma_wait<1>();  // S of tile it (groups retire in order)
    fence_operand(s);
    mbar_arrive(&empty_k[it % kS]);
    uint32_t pn[BK / 16][4];
    softmax(it, pn, corr);
    wgmma_wait<0>();  // P V of tile it - 1: pa and o are free
    fence_operand(o);
    fence_operand(pa);
    mbar_arrive(&empty_v[(it - 1) % kS]);
    rescale(corr);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) pa[kk][r] = pn[kk][r];
  }
  mbar_wait(&full_v[(n_tiles - 1) % kS], ((n_tiles - 1) / kS) & 1);
  issue_pv(n_tiles - 1, pa);
  wgmma_wait<0>();
  fence_operand(o);
  fence_operand(pa);

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_run[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int m = m0 + r0 + 8 * h;
    if (m >= M) continue;
    const float inv = 1.f / fmaxf(l, 1e-30f);
    bf16* orow = out + (static_cast<int64_t>(bkv) * M + m) * D + col;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + 2 * h] * inv, o[4 * j + 2 * h + 1] * inv);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, looked up through the runtime (no -lcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A [heads][rows][D] bf16 tensor as boxes of 64 columns x `box_rows` rows.
bool make_map(CUtensorMap* map, const void* ptr, int D, int rows, int heads, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(rows) * D * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <int D, int BQ, int BK>
int launch_wgmma(const void* q, const void* k, const void* v, void* out, int BKV, int G, int Sq,
                 int Sk, int causal, cudaStream_t stream) {
  using Tl = WgTiles<D, BQ, BK>;
  auto kernel = flash_wgmma_kernel<D, BQ, BK>;
  static bool raised[64] = {};  // the attribute, once per device and instantiation
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 64 || !raised[dev]) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tl::kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) raised[dev] = true;
  }
  const int64_t M = static_cast<int64_t>(G) * Sq;
  const int64_t m_tiles = (M + BQ - 1) / BQ;
  if (M > INT_MAX || BKV > 65535) return -1;
  Maps maps;
  if (!make_map(&maps.q, q, D, static_cast<int>(M), BKV, BQ) ||
      !make_map(&maps.k, k, D, Sk, BKV, BK) || !make_map(&maps.v, v, D, Sk, BKV, BK))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(m_tiles), BKV);
  kernel<<<grid, Tl::kThreads, Tl::kBytes, stream>>>(maps, static_cast<bf16*>(out), G, Sq, Sk,
                                                     causal);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------ dispatch

template <int D>
int launch_d(const void* q, const void* k, const void* v, void* out, int BKV, int G, int Sq,
             int Sk, int causal, int block_q, int block_k, int dtype, cudaStream_t st) {
#define REPRO_TILE(BQ, BK)                                                                  \
  if (block_q == BQ && block_k == BK)                                                       \
    return launch_tile<float, D, BQ, BK>(q, k, v, out, BKV, G, Sq, Sk, causal, st);
#define REPRO_WG(BQ, BK)                                                                    \
  if (block_q == BQ && block_k == BK)                                                       \
    return launch_wgmma<D, BQ, BK>(q, k, v, out, BKV, G, Sq, Sk, causal, st);
  if (dtype == repro::kF32) {
    REPRO_TILE(16, 32) REPRO_TILE(32, 32) REPRO_TILE(32, 64) REPRO_TILE(64, 64)
  } else {
    REPRO_WG(64, 64) REPRO_WG(64, 128) REPRO_WG(128, 64) REPRO_WG(128, 128)
  }
#undef REPRO_WG
#undef REPRO_TILE
  return -1;  // tile not instantiated for this dtype
}

}  // namespace

// dtype: 0 = float32 (CUDA cores; tiles (16, 32), (32, 32), (32, 64), (64,
// 64)), 1 = bfloat16 (wgmma; tiles (64, 64), (64, 128), (128, 64), (128,
// 128)). D: 16, 32, 64, 80 or 128. Returns cudaGetLastError() after the
// launch, -1 for an unsupported D, tile or shape, -2 for an unsupported dtype.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* out,
                                     int BKV, int G, int Sq, int Sk, int D, int causal,
                                     int block_q, int block_k, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != repro::kF32 && dtype != repro::kBF16) return -2;
#define REPRO_CASE(DD)                                                                      \
  if (D == DD)                                                                              \
    return launch_d<DD>(q, k, v, out, BKV, G, Sq, Sk, causal, block_q, block_k, dtype, st);
  REPRO_CASE(16) REPRO_CASE(32) REPRO_CASE(64) REPRO_CASE(80) REPRO_CASE(128)
#undef REPRO_CASE
  return -1;  // D not instantiated
}
