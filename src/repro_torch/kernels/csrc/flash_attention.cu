// Causal GQA prefill flash attention.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::gqa_flash_attention
// (_gqa_flash_kernel over _flash_tile_body and _online_softmax_update):
// q [BKV, G, Sq, D], k/v [BKV, Sk, D]; query i sees key j iff j < Sk (the
// kv_len tail mask) and, when causal, j <= i. Returns [BKV, G, Sq, D].
//
// What bounds it on the H100: at the prompt lengths the engine prefills
// (buckets up to the prefill budget, 64 tokens by default) the bytes of q, k,
// v and out; for long prompts the 4 * Sq * Sk / 2 * D flops per head, which
// only tensor cores (wgmma) can deliver at the card's rate.
//
// Simple design: one block per (B*KV row, query head g of the group, 16-row Q
// tile) — the TPU grid (bkv, g, q tiles) with its sequential K axis turned
// into a loop inside the block that stops at the causal diagonal. K/V are
// read from their [BKV, Sk, D] rows, never repeated across the group. Each
// 32-key K/V tile is staged in shared memory as f32 (rows padded by one word
// so the per-lane dot products hit distinct banks; 41 KB at D = 128, under
// the 48 KB static limit); each of the 4 warps owns 4 query rows, lane c
// scores key c, and the online softmax runs in f32 registers. CUDA-core f32
// math throughout: tensor cores, TMA and pipelining are later work.

#include "attention_common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kBQ = 16;  // query rows per block
constexpr int kBK = 32;  // keys per tile: one per lane
constexpr int kRowsPerWarp = kBQ / kWarps;

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
gqa_flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, int G, int Sq, int Sk, int causal) {
  constexpr int N = D / 32;
  __shared__ float qs[kBQ][D];
  __shared__ float ks[kBK][D + 1];
  __shared__ float vs[kBK][D + 1];

  const int bkv = blockIdx.x, g = blockIdx.y, q0 = blockIdx.z * kBQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t qo_base = ((static_cast<int64_t>(bkv) * G + g) * Sq) * D;
  const T* kb = k + static_cast<int64_t>(bkv) * Sk * D;
  const T* vb = v + static_cast<int64_t>(bkv) * Sk * D;
  const float scale = rsqrtf(static_cast<float>(D));

  for (int idx = threadIdx.x; idx < kBQ * D; idx += kWarps * 32) {
    const int r = idx / D, c = idx % D;
    qs[r][c] = q0 + r < Sq ? repro::to_f32(q[qo_base + static_cast<int64_t>(q0 + r) * D + c]) : 0.f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][N];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = repro::kNegInf;
    l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i) acc[rr][i] = 0.f;
  }

  // keys past the last query row of this tile are masked for every row
  const int k_end = causal ? min(Sk, q0 + kBQ) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile is consumed (and qs is written)
    for (int idx = threadIdx.x; idx < kBK * D; idx += kWarps * 32) {
      const int r = idx / D, c = idx % D;
      const bool ok = k0 + r < Sk;
      const int64_t off = static_cast<int64_t>(k0 + r) * D + c;
      ks[r][c] = ok ? repro::to_f32(kb[off]) : 0.f;
      vs[r][c] = ok ? repro::to_f32(vb[off]) : 0.f;
    }
    __syncthreads();
    const int key = k0 + lane;
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      float s = 0.f;
#pragma unroll 16
      for (int c = 0; c < D; ++c) s += qs[r][c] * ks[lane][c];
      s *= scale;
      const bool valid = key < Sk && (!causal || key <= q0 + r);
      const float m_new = fmaxf(m[rr], repro::warp_max(valid ? s : repro::kNegInf));
      const float p = valid ? expf(s - m_new) : 0.f;
      const float corr = expf(m[rr] - m_new);
      l[rr] = l[rr] * corr + repro::warp_sum(p);
#pragma unroll
      for (int i = 0; i < N; ++i) acc[rr][i] *= corr;
#pragma unroll 8
      for (int c = 0; c < kBK; ++c) {
        const float pc = __shfl_sync(0xffffffffu, p, c);
#pragma unroll
        for (int i = 0; i < N; ++i) acc[rr][i] += pc * vs[c][lane + 32 * i];
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
    for (int i = 0; i < N; ++i)
      repro::store_f32(out + qo_base + static_cast<int64_t>(row) * D + lane + 32 * i,
                       acc[rr][i] * inv);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int BKV, int G, int Sq,
           int Sk, int D, int causal, cudaStream_t stream) {
  const dim3 grid(BKV, G, (Sq + kBQ - 1) / kBQ);
#define REPRO_CASE(DD)                                                                  \
  if (D == DD) {                                                                        \
    gqa_flash_kernel<T, DD><<<grid, kWarps * 32, 0, stream>>>(                          \
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),   \
        static_cast<T*>(out), G, Sq, Sk, causal);                                       \
    return static_cast<int>(cudaGetLastError());                                        \
  }
  REPRO_CASE(64) REPRO_CASE(128)
#undef REPRO_CASE
  return -1;  // D not instantiated
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch, -1 for an unsupported D, -2 for an unsupported dtype.
extern "C" int repro_gqa_flash_attention(const void* q, const void* k, const void* v, void* out,
                                         int BKV, int G, int Sq, int Sk, int D, int causal,
                                         int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(q, k, v, out, BKV, G, Sq, Sk, D, causal, st);
  if (dtype == 1) return launch<__nv_bfloat16>(q, k, v, out, BKV, G, Sq, Sk, D, causal, st);
  return -2;
}
