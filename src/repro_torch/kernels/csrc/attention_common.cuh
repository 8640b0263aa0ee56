// Shared device code of the serving attention kernels: decode, ragged and
// paged attention.
//
// All three compute, for one query token and one KV head, softmax(q k^T /
// sqrt(D)) v over the contiguous key range [lo, hi] of one sequence, for the
// G query heads that share the KV head. Decode is the special case "token b
// reads slot b at position cur_len[b]"; ragged reads (tok_slot[t],
// tok_pos[t]); paged reads (tok_seq[t], tok_pos[t]) through a block table.
// Decode and paged attention run split_attention.cuh's split-KV body over
// this file's loads and ranges; ragged runs attention_kernel below.
//
// The domain is every head width D of 16, 32, 64, 80 or 128 (the cases of
// launch_attention and launch_split) with every group G from 1 to kMaxGroup
// (16): the group runs in chunks of 1, 4 or 8 rows held in registers, one
// chunk per block along gridDim.z, so 5 widths x 3 chunk sizes cover it
// (kernels/_checks.py states the same domain). D stays a template
// parameter: with D a runtime value the int8 ragged kernel ran 14% slower
// (its address arithmetic; one A/B of scripts/torch_attention_ab.py on an
// H100).
//
// Three things vary, each resolved where it costs nothing in the key loop:
// - the query/output type TQ (f32 or bf16, the model dtype) and the K/V
//   store type TS (f32, bf16, int8 or fp8 e4m3), as template parameters;
//   every element is widened to f32 in registers, all math is f32;
// - an optional f32 scale per (position, head) row of K and of V (the
//   quantized cache): a null pointer means unscaled. The host picks the
//   scaled or the unscaled instantiation from that pointer, so an unscaled
//   kernel carries no scale pointers, loads or registers in its key loop;
// - how key t maps to a cache row: contiguous in one slot for the dense
//   cache (DenseRows here, DenseSlots in decode_attention.cu), block by
//   block through a table row for the paged pool (PagedTable in
//   paged_attention.cu).
//
// The ragged kernel (attention_kernel) and its launch (launch_attention)
// take an Index policy (token t's key range and Rows).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace repro {

constexpr float kNegInf = -1e30f;  // the reference's masked-score value

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// N contiguous elements at p (aligned to N elements) widened to f32: one
// vector load per lane (16 bytes of f32, 8 of bf16, 4 of int8 or fp8 at N = 4).
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

template <int N>
__device__ __forceinline__ void load_vec(const int8_t* __restrict__ p, float (&o)[N]) {
  if constexpr (N == 4) {
    const char4 x = *reinterpret_cast<const char4*>(p);
    o[0] = static_cast<float>(x.x); o[1] = static_cast<float>(x.y);
    o[2] = static_cast<float>(x.z); o[3] = static_cast<float>(x.w);
  } else if constexpr (N == 2) {
    const char2 x = *reinterpret_cast<const char2*>(p);
    o[0] = static_cast<float>(x.x); o[1] = static_cast<float>(x.y);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = static_cast<float>(p[i]);
  }
}

template <int N>
__device__ __forceinline__ void load_vec(const __nv_fp8_e4m3* __restrict__ p, float (&o)[N]) {
  if constexpr (N == 4) {
    const float4 x = static_cast<float4>(*reinterpret_cast<const __nv_fp8x4_e4m3*>(p));
    o[0] = x.x; o[1] = x.y; o[2] = x.z; o[3] = x.w;
  } else if constexpr (N == 2) {
    const float2 x = static_cast<float2>(*reinterpret_cast<const __nv_fp8x2_e4m3*>(p));
    o[0] = x.x; o[1] = x.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = static_cast<float>(p[i]);
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

// Key t of a dense cache slot: row base + t.
struct DenseRows {
  int64_t base;  // slot * S_max
  __device__ __forceinline__ int64_t operator()(int t) const { return base + t; }
};

// Attention of gn query rows (q: [gn, D]) over keys lo..hi of one sequence
// and KV head, written to out ([gn, D]). Key t's K row starts at
// k + rows(t) * row_stride (k, v already offset to the head) and, with
// kScaled, its scale at k_scale[rows(t) * scale_stride] (k_scale, v_scale
// already offset to the head). Called by a block of NW warps.
//
// Lane i holds elements [i*N, i*N + N) of a row (N = 1 up to D = 32, 2 up to
// 64, 4 up to 128), so a key row is one coalesced warp-wide load. D = 16 and
// 80 leave lanes past the row idle: their query is zero, so they add 0 to
// every warp sum, and their sums are never read, so they load the row's
// first elements (in bounds, no branch). The chunk's rows are held in
// registers up to GC: rows gn .. GC - 1 (past the group) repeat row 0 and
// are never stored.
//
// Each warp walks the valid range in steps of U keys, round-robin with the
// other warps, and keeps its own online-softmax state (m, l, acc) for the
// rows in registers. The U loads of a step are issued before any of them is
// used, which keeps NW*U K and V rows in flight per block. A row scale is
// folded into the math, never into a stored row: s = ks * (q . k_stored) /
// sqrt(D) and acc += (p * vs) * v_stored. At the end the NW partial states
// are merged through shared memory. An empty range (lo > hi) writes zeros,
// as the TPU kernel does.
template <typename TQ, typename TS, bool kScaled, int D, int GC, int NW, int U, typename Rows>
__device__ __forceinline__ void attend_rows(
    const TQ* __restrict__ q, const TS* __restrict__ k, const TS* __restrict__ v,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale, int64_t row_stride,
    int scale_stride, const Rows& rows, int lo, int hi, int gn, TQ* __restrict__ out) {
  constexpr int N = D <= 32 ? 1 : D <= 64 ? 2 : 4;
  static_assert(D % N == 0 && D <= 32 * N, "a row must fit a warp's lanes");
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool active = D == 32 * N || lane * N < D;
  const int col = active ? lane * N : 0;
  const float scale = rsqrtf(static_cast<float>(D));

  float qr[GC][N];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    load_vec<N>(q + (g < gn ? g : 0) * D + col, qr[g]);
#pragma unroll
    for (int i = 0; i < N; ++i) qr[g][i] = active ? qr[g][i] : 0.f;
  }

  float m[GC], l[GC], acc[GC][N];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i) acc[g][i] = 0.f;
  }

  for (int base = lo + warp * U; base <= hi; base += NW * U) {
    float kr[U][N], vr[U][N], ks[U], vs[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = base + u;
      ks[u] = vs[u] = 1.f;
      if (t <= hi) {
        const int64_t p = rows(t);
        load_vec<N>(k + p * row_stride + col, kr[u]);
        load_vec<N>(v + p * row_stride + col, vr[u]);
        if constexpr (kScaled) {
          ks[u] = __ldg(k_scale + p * scale_stride);
          vs[u] = __ldg(v_scale + p * scale_stride);
        }
      } else {
#pragma unroll
        for (int i = 0; i < N; ++i) kr[u][i] = vr[u][i] = 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      float s[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < N; ++i) part += qr[g][i] * kr[u][i];
        s[u] = warp_sum(part) * scale;
        if constexpr (kScaled) s[u] *= ks[u];
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
        if constexpr (kScaled) p[u] *= vs[u];  // the V row's scale rides on its weight
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

  constexpr int kWidth = 32 * N;  // the widest row a lane layout of N holds
  __shared__ float sm_m[NW][GC];
  __shared__ float sm_l[NW][GC];
  __shared__ float sm_acc[NW][GC][kWidth];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int i = 0; i < N; ++i) sm_acc[warp][g][lane * N + i] = acc[g][i];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < gn * D; idx += NW * 32) {
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

// Key range of a packed token: a padding token (pos >= S) gets the empty
// range, so it reads no key and comes out as zeros.
__device__ __forceinline__ void token_key_range(int pos, int S, int window, int* lo, int* hi) {
  *lo = 1;
  *hi = 0;
  if (pos < S) key_range(pos, S, window, lo, hi);
}

constexpr int kWarps = 8;  // warps per block of every attention kernel

// The widest group of the decode, ragged and paged kernels
// (kernels/_checks.py's attention_domain states the same domain).
constexpr int kMaxGroup = 16;

// One block per (token t, KV head h, chunk c of the group): attention of
// the token's query rows c*GC .. min(G, c*GC + GC) - 1 (q, out: [T, KV, G,
// D]) over the keys index.range(t) of the rows index.rows(t). K/V rows are
// [.., KV, D] per position, scales [.., KV]. A group wider than GC is split
// over gridDim.z; its chunks read the same K/V rows, the later ones from L2.
template <typename TQ, typename TS, bool kScaled, int D, int GC, typename Index>
__global__ void __launch_bounds__(kWarps * 32)
attention_kernel(const TQ* __restrict__ q, const TS* __restrict__ k, const TS* __restrict__ v,
                 const float* __restrict__ k_scale, const float* __restrict__ v_scale,
                 const Index index, TQ* __restrict__ out, int KV, int G, int window) {
  constexpr int U = GC >= 4 ? 2 : 4;
  const int t = blockIdx.x, h = blockIdx.y, g0 = blockIdx.z * GC;
  int lo, hi;
  index.range(t, window, &lo, &hi);
  const int64_t q_off = ((static_cast<int64_t>(t) * KV + h) * G + g0) * D;
  attend_rows<TQ, TS, kScaled, D, GC, kWarps, U>(
      q + q_off, k + h * D, v + h * D, k_scale ? k_scale + h : nullptr,
      v_scale ? v_scale + h : nullptr, static_cast<int64_t>(KV) * D, KV, index.rows(t), lo,
      hi, min(GC, G - g0), out + q_off);
}

// Storage codes shared with kernels/_checks.py.
enum DType { kF32 = 0, kBF16 = 1, kI8 = 2, kF8 = 3 };

template <typename T>
struct Tag {
  using type = T;
};

// Calls f(Tag<TQ>{}, Tag<TS>{}, std::bool_constant<kScaled>{}) for the
// (query, store, scaled) combinations the serving path uses: a f32 or bf16
// model over an unscaled store of its own type, the f32 identity lane (a
// scaled f32 store, under f32 or bf16 queries), and a f32 or bf16 model over
// scaled int8/fp8 rows. Returns -2 for any other combination.
template <typename F>
int dispatch_types(int qdtype, int sdtype, bool scaled, F&& f) {
  using Plain = std::false_type;
  using Scaled = std::true_type;
  if (qdtype == kF32) {
    if (sdtype == kF32) {
      return scaled ? f(Tag<float>{}, Tag<float>{}, Scaled{})
                    : f(Tag<float>{}, Tag<float>{}, Plain{});
    }
    if (sdtype == kI8 && scaled) return f(Tag<float>{}, Tag<int8_t>{}, Scaled{});
    if (sdtype == kF8 && scaled) return f(Tag<float>{}, Tag<__nv_fp8_e4m3>{}, Scaled{});
  } else if (qdtype == kBF16) {
    if (sdtype == kBF16 && !scaled) {
      return f(Tag<__nv_bfloat16>{}, Tag<__nv_bfloat16>{}, Plain{});
    }
    if (sdtype == kF32 && scaled) return f(Tag<__nv_bfloat16>{}, Tag<float>{}, Scaled{});
    if (sdtype == kI8 && scaled) return f(Tag<__nv_bfloat16>{}, Tag<int8_t>{}, Scaled{});
    if (sdtype == kF8 && scaled) {
      return f(Tag<__nv_bfloat16>{}, Tag<__nv_fp8_e4m3>{}, Scaled{});
    }
  }
  return -2;
}

// Launches attention_kernel over a grid of (T tokens, KV heads, chunks of
// the group) for the instantiated (query, store, scaled) combination
// (dispatch_types), head width D and chunk GC: 1 for G = 1, 4 for G up to
// 4, else 8 (G over 8 takes two chunks; rows past G are computed, not
// stored). k_scale / v_scale are null for an unscaled store. Returns cudaGetLastError() after
// the launch, -1 for a (D, G) outside the domain, -2 for an unsupported
// combination of types and scales.
template <typename Index>
int launch_attention(const void* q, const void* k, const void* v, const void* k_scale,
                     const void* v_scale, const Index& index, void* out, int T, int KV, int G,
                     int D, int window, int qdtype, int sdtype, void* stream) {
  if (G < 1 || G > kMaxGroup) return -1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int gc = G == 1 ? 1 : G <= 4 ? 4 : 8;
  const dim3 grid(T, KV, (G + gc - 1) / gc);
  return dispatch_types(qdtype, sdtype, k_scale != nullptr, [&](auto tq, auto ts, auto sc) {
    using TQ = typename decltype(tq)::type;
    using TS = typename decltype(ts)::type;
    constexpr bool kScaled = decltype(sc)::value;
#define REPRO_CASE(DD, GG)                                                                \
  if (D == DD && gc == GG) {                                                              \
    attention_kernel<TQ, TS, kScaled, DD, GG, Index><<<grid, kWarps * 32, 0, st>>>(       \
        static_cast<const TQ*>(q), static_cast<const TS*>(k), static_cast<const TS*>(v),  \
        static_cast<const float*>(k_scale), static_cast<const float*>(v_scale), index,    \
        static_cast<TQ*>(out), KV, G, window);                                            \
    return static_cast<int>(cudaGetLastError());                                          \
  }
    REPRO_CASE(16, 1) REPRO_CASE(16, 4) REPRO_CASE(16, 8)
    REPRO_CASE(32, 1) REPRO_CASE(32, 4) REPRO_CASE(32, 8)
    REPRO_CASE(64, 1) REPRO_CASE(64, 4) REPRO_CASE(64, 8)
    REPRO_CASE(80, 1) REPRO_CASE(80, 4) REPRO_CASE(80, 8)
    REPRO_CASE(128, 1) REPRO_CASE(128, 4) REPRO_CASE(128, 8)
#undef REPRO_CASE
    return -1;
  });
}

}  // namespace repro
