// Shared device code of the decode and ragged attention kernels.
//
// Both kernels compute, for one query token and one KV head, softmax(q k^T /
// sqrt(D)) v over the contiguous key range [lo, hi] of one cache slot, for the
// G query heads that share the KV head. Decode is the special case "token b
// reads slot b at position cur_len[b]"; ragged reads (tok_slot[t],
// tok_pos[t]). Storage is f32 or bf16; all math is f32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr float kNegInf = -1e30f;  // the reference's masked-score value

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// N contiguous elements at p (aligned to N elements) widened to f32.
template <int N>
__device__ __forceinline__ void load_vec(const float* __restrict__ p, float (&o)[N]) {
  if constexpr (N == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    o[0] = x.x; o[1] = x.y; o[2] = x.z; o[3] = x.w;
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    o[0] = x.x; o[1] = x.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = p[i];
  }
}

template <int N>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* __restrict__ p, float (&o)[N]) {
  if constexpr (N == 4) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
  } else if constexpr (N == 2) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    o[0] = a.x; o[1] = a.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = __bfloat162float(p[i]);
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Attention of G query rows (q: [G, D]) over cache rows lo..hi of one slot
// and KV head (k/v point at position 0; row_stride elements between
// positions), written to out ([G, D]). Called by a block of NW warps.
//
// Each warp walks the valid range in steps of U keys, round-robin with the
// other warps, and keeps its own online-softmax state (m, l, acc) for the G
// rows in registers: lane i holds elements [i*N, i*N + N) of every row, so a
// key row is one coalesced warp-wide load. The U loads of a step are issued
// before any of them is used, which keeps NW*U K and V rows in flight per
// block. At the end the NW partial states are merged through shared memory.
// An empty range (lo > hi) writes zeros, as the TPU kernel does.
template <typename T, int D, int G, int NW, int U>
__device__ __forceinline__ void attend_rows(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    int64_t row_stride, int lo, int hi, T* __restrict__ out) {
  static_assert(D % 32 == 0, "head_dim must be a multiple of 32");
  constexpr int N = D / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float scale = rsqrtf(static_cast<float>(D));

  float qr[G][N];
#pragma unroll
  for (int g = 0; g < G; ++g) load_vec<N>(q + g * D + lane * N, qr[g]);

  float m[G], l[G], acc[G][N];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i) acc[g][i] = 0.f;
  }

  for (int base = lo + warp * U; base <= hi; base += NW * U) {
    float kr[U][N], vr[U][N];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = base + u;
      if (t <= hi) {
        load_vec<N>(k + t * row_stride + lane * N, kr[u]);
        load_vec<N>(v + t * row_stride + lane * N, vr[u]);
      } else {
#pragma unroll
        for (int i = 0; i < N; ++i) kr[u][i] = vr[u][i] = 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float s[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < N; ++i) part += qr[g][i] * kr[u][i];
        s[u] = warp_sum(part) * scale;
      }
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (base + u <= hi) mx = fmaxf(mx, s[u]);
      const float corr = expf(m[g] - mx);
      float p[U], psum = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        p[u] = (base + u <= hi) ? expf(s[u] - mx) : 0.f;
        psum += p[u];
      }
      l[g] = l[g] * corr + psum;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        float a = acc[g][i] * corr;
#pragma unroll
        for (int u = 0; u < U; ++u) a += p[u] * vr[u][i];
        acc[g][i] = a;
      }
      m[g] = mx;
    }
  }

  __shared__ float sm_m[NW][G];
  __shared__ float sm_l[NW][G];
  __shared__ float sm_acc[NW][G][D];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int i = 0; i < N; ++i) sm_acc[warp][g][lane * N + i] = acc[g][i];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * D; idx += NW * 32) {
    const int g = idx / D, d = idx % D;
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < NW; ++w) mm = fmaxf(mm, sm_m[w][g]);
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float c = expf(sm_m[w][g] - mm);
      ll += sm_l[w][g] * c;
      aa += sm_acc[w][g][d] * c;
    }
    store_f32(out + idx, aa / fmaxf(ll, 1e-30f));
  }
}

// Key range of a token at position pos: keys p <= pos that exist in the
// cache (a position past the cache sees the whole slot), and with a window
// only p > pos - window.
__device__ __forceinline__ void key_range(int pos, int S, int window, int* lo, int* hi) {
  *hi = min(pos, S - 1);
  *lo = window > 0 ? max(0, pos - window + 1) : 0;
}

}  // namespace repro
