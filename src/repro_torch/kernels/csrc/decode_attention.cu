// Batched single-token GQA decode attention against the dense KV cache, over
// a plain (f32/bf16) or a quantized (int8/fp8 rows + f32 row scales) store.
//
// Replaces the TPU kernels repro/kernels/decode_attention.py::decode_attention
// (_decode_kernel, and _decode_kernel_q8 for the quantized store): q [B, KV,
// G, D], cache k/v [B, S_max, KV, D], cur_len [B] int32, and for a quantized
// store k_scale/v_scale [B, S_max, KV] f32; key t of slot b is valid iff t <=
// cur_len[b] (and t > cur_len[b] - window when window > 0). Returns [B, KV,
// G, D] in q's dtype.
//
// What bounds it on the H100: the K/V bytes of the valid prefix (plus 8 bytes
// of scales per key and head when quantized). Per slot and head it reads 2 *
// (cur_len + 1) rows of D elements and does 4 * G * D flops per key, far below
// the ~295 flops per byte where tensor cores would become the limit, so the
// kernel is a streaming read; an int8 or fp8 store halves the bytes of bf16.
// At the serving shape (4 slots, 32 KV heads, G = 1) one block per (slot,
// head) is 128 blocks on 132 SMs, too few bytes in flight to stream at the
// HBM rate.
//
// The design: split-KV decode (flash-decoding), split_attention.cuh's body
// with one token a tile (token b is slot b) and a dense row policy: the TPU
// grid's S axis (block_s = 256) comes back as a grid axis of spans that
// kernels/decode_attention.py::split_count picks from host values only (S_max,
// B, KV, G, the SM count) so that the blocks fill at least two waves.

#include "split_attention.cuh"

namespace {

using repro::splitkv::launch_split;

// Token t of a decode over the dense cache: slot t at cur_len[t], key p at
// cache row t * S + p.
struct DenseSlots {
  static constexpr bool kTable = false;
  static constexpr bool kMmaRows = false;  // LaneRows' arithmetic, even at 8 rows
  const int* __restrict__ cur_len;
  int S;
  __device__ __forceinline__ int seq(int t) const { return t; }
  __device__ __forceinline__ void range(int t, int window, int* lo, int* hi) const {
    repro::key_range(cur_len[t], S, window, lo, hi);
  }
  __device__ __forceinline__ int window_end(int lo, int hi) const { return hi; }
  __device__ __forceinline__ int bind(int, int, int, int*) const { return 0; }
  __device__ __forceinline__ int64_t row(int seq, int p, const int*, int) const {
    return static_cast<int64_t>(seq) * S + p;
  }
};

}  // namespace

// qdtype: the type of q and out; sdtype: the K/V store (repro::DType codes).
// k_scale/v_scale: null for an unscaled store. span: positions per split
// (kernels/decode_attention.py::split_span), so splits = ceil(S / span); ws:
// f32 scratch of B * KV * G * splits * (D + 2) elements and counters: int32
// zeros, one per (slot, KV head, chunk of the group), left zero — both may
// be null when splits == 1. Returns as repro::splitkv::launch_split.
extern "C" int repro_decode_attention(const void* q, const void* k, const void* v,
                                      const void* k_scale, const void* v_scale,
                                      const void* cur_len, void* ws, void* counters, void* out,
                                      int B, int S, int KV, int G, int D, int window, int span,
                                      int qdtype, int sdtype, void* stream) {
  const DenseSlots slots{static_cast<const int*>(cur_len), S};
  return launch_split<false>(q, k, v, k_scale, v_scale, slots, out, ws, counters, B, S, KV, G,
                             D, window, span, qdtype, sdtype, stream);
}
