// Flash attention: flat and GQA prefill, causal or not.
//
// Replaces the TPU kernels repro/kernels/flash_attention.py::flash_attention
// (_flash_kernel) and ::gqa_flash_attention (_gqa_flash_kernel), both over
// _flash_tile_body and _online_softmax_update: q [BKV, G, Sq, D], k/v
// [BKV, Sk, D]; query i sees key j iff j < Sk (the kv_len tail mask) and,
// when causal, j <= i (top-left aligned, also when Sq != Sk). Returns
// [BKV, G, Sq, D]. The flat op is G = 1 with one grid row per (batch, head).
//
// What bounds it on the H100: at the prompt lengths the engine prefills
// (buckets up to the prefill budget, 64 tokens by default) the bytes of q, k,
// v and out; for long prompts (the kernel API's S = 1024) the 4 * Sq * Sk / 2
// * D flops per head, which only tensor cores (wgmma) can deliver at the
// card's rate.
//
// Simple design: one block per (B*KV row, query head g of the group,
// BQ-row Q tile) — the TPU grid (bkv, g, q tiles) with its sequential K axis
// turned into a loop inside the block that stops at the causal diagonal. K/V
// are read from their [BKV, Sk, D] rows, never repeated across the group.
// Each BK-key K/V tile is staged in shared memory as f32 (rows padded by one
// word so the per-lane dot products hit distinct banks); each warp owns 4
// query rows, lane c scores keys c, c + 32, ... of the tile, and the online
// softmax runs in f32 registers. Lane c owns output columns c, c + 32, ...
// (lanes past D idle in P.V at D = 16). The tile (BQ, BK) is the autotuner's
// knob: (16, 32) is the serving default, (32, 32), (32, 64) and (64, 64) the
// other candidates; tiles above the 48 KB of static shared memory take
// dynamic shared memory (98 KB at (64, 64), D = 128).
// CUDA-core f32 math throughout: tensor cores, TMA and pipelining are later
// work.

#include "attention_common.cuh"

namespace {

constexpr int kRowsPerWarp = 4;

template <int D, int BQ, int BK>
struct Tiles {
  float q[BQ][D];
  float k[BK][D + 1];
  float v[BK][D + 1];
};

// Static shared memory where the tiles fit its 48 KB (the serving default
// (16, 32) at every D), dynamic shared memory above: with dynamic shared
// memory the default tile ran 13% slower at the engine's 64-token prefill
// (0.0184 against 0.0163 ms, scripts/torch_attention_ab.py, H100 SXM).
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

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* out, int BKV, int G, int Sq,
             int Sk, int causal, int block_q, int block_k, cudaStream_t st) {
#define REPRO_TILE(BQ, BK)                                                          \
  if (block_q == BQ && block_k == BK)                                               \
    return launch_tile<T, D, BQ, BK>(q, k, v, out, BKV, G, Sq, Sk, causal, st);
  REPRO_TILE(16, 32) REPRO_TILE(32, 32) REPRO_TILE(32, 64) REPRO_TILE(64, 64)
#undef REPRO_TILE
  return -1;  // tile not instantiated
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int BKV, int G, int Sq,
           int Sk, int D, int causal, int block_q, int block_k, cudaStream_t st) {
#define REPRO_CASE(DD)                                                                  \
  if (D == DD)                                                                          \
    return launch_d<T, DD>(q, k, v, out, BKV, G, Sq, Sk, causal, block_q, block_k, st);
  REPRO_CASE(16) REPRO_CASE(32) REPRO_CASE(64) REPRO_CASE(128)
#undef REPRO_CASE
  return -1;  // D not instantiated
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. (block_q, block_k): one of (16, 32),
// (32, 32), (32, 64), (64, 64). Returns cudaGetLastError() after the launch,
// -1 for an unsupported D or tile, -2 for an unsupported dtype.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* out,
                                     int BKV, int G, int Sq, int Sk, int D, int causal,
                                     int block_q, int block_k, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, out, BKV, G, Sq, Sk, D, causal, block_q, block_k, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, BKV, G, Sq, Sk, D, causal, block_q, block_k, st);
  return -2;
}
