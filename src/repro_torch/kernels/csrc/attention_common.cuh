// Shared device code of the serving attention kernels: decode, ragged and
// paged attention, which all run split_attention.cuh's split-KV body.
//
// All three compute, for one query token and one KV head, softmax(q k^T /
// sqrt(D)) v over the contiguous key range [lo, hi] of one sequence, for the
// G query heads that share the KV head. Decode is the special case "token b
// reads slot b at position cur_len[b]"; ragged reads (tok_slot[t],
// tok_pos[t]); paged reads (tok_seq[t], tok_pos[t]) through a block table.
// This file holds what the body and its row policies share: the element
// types and their widening loads, the key ranges, the group limit and the
// (query, store, scaled) dispatch.
//
// The domain is every head width D of 16, 32, 64, 80 or 128 (the cases of
// launch_split) with every group G from 1 to kMaxGroup (16): the group runs
// in chunks of 1, 4 or 8 rows, one chunk per block along gridDim.z, so 5
// widths x 3 chunk sizes cover it (kernels/_checks.py states the same
// domain). D stays a template parameter: with D a runtime value the int8
// ragged kernel ran 14% slower (its address arithmetic; one A/B of
// scripts/torch_attention_ab.py on an H100).
//
// Three things vary, each resolved where it costs nothing in the key loop:
// - the query/output type TQ (f32 or bf16, the model dtype) and the K/V
//   store type TS (f32, bf16, int8 or fp8 e4m3), as template parameters;
// - an optional f32 scale per (position, head) row of K and of V (the
//   quantized cache): a null pointer means unscaled. The host picks the
//   scaled or the unscaled instantiation from that pointer, so an unscaled
//   kernel carries no scale pointers, loads or registers in its key loop;
// - how key p of a sequence maps to a cache row: contiguous in one slot for
//   the dense cache (DenseSlots in decode_attention.cu, RaggedSlots in
//   ragged_slots.cuh), block by block through a table row for the paged pool
//   (PagedTable in paged_table.cuh).
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

// The widest group of the decode, ragged and paged kernels
// (kernels/_checks.py's attention_domain states the same domain).
constexpr int kMaxGroup = 16;

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

}  // namespace repro
