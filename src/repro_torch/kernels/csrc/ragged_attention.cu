// Packed variable-length (ragged) attention: a flat [T] token batch — prefill
// chunks and decode singletons of any slots mixed — against the dense cache,
// over a plain (f32/bf16) or a quantized (int8/fp8 rows + f32 row scales)
// store.
//
// Replaces the TPU kernels repro/kernels/ragged_attention.py::ragged_attention
// (_ragged_kernel, and _ragged_kernel_q8 for the quantized store): q [T, KV,
// G, D], cache k/v [B, S_max, KV, D], for a quantized store k_scale/v_scale
// [B, S_max, KV] f32, per-token descriptors tok_slot/tok_pos [T] int32; key p
// of slot tok_slot[t] is valid iff p <= tok_pos[t] (and p > tok_pos[t] -
// window when window > 0). The tokens' own K/V were scattered into the cache
// before the call. Padding tokens carry tok_pos >= S_max: nothing reads their
// output rows, so their key range is empty and they come out as zeros without
// touching the cache (the TPU kernel and the plain version attend the whole
// slot there). Returns [T, KV, G, D] in q's dtype.
//
// tok_slot holds GLOBAL cache rows. The JAX model gathers the pack's P slots
// into a sub-cache and passes local indices; reading the full cache at
// pack_slots[local] is the same result without the gather copy.
//
// What bounds it on the H100: the K/V bytes (and scale bytes) of each real
// token's valid prefix. Tokens of one prefill chunk share their slot's rows,
// so the bytes the function must move are the union of those prefixes; this
// simple kernel reads them once per token and leans on the 50 MB L2 for the
// reuse.
//
// Simple design: one block per (packed token, KV head, chunk of the group),
// each block reading its own (slot, pos) — the TPU kernel's
// scalar-prefetched index map becomes two loads at block start — then the
// same in-block loop over the valid key
// range as the decode kernel (attention_common.cuh), widening quantized rows
// in registers with their scales folded into the math. Sharing K/V tiles
// between the tokens of a chunk is later work.

#include "attention_common.cuh"

namespace {

// Token t at position tok_pos[t] of cache slot tok_slot[t].
struct RaggedIndex {
  const int* __restrict__ tok_slot;
  const int* __restrict__ tok_pos;
  int S;
  __device__ __forceinline__ void range(int t, int window, int* lo, int* hi) const {
    repro::token_key_range(tok_pos[t], S, window, lo, hi);
  }
  __device__ __forceinline__ repro::DenseRows rows(int t) const {
    return {static_cast<int64_t>(tok_slot[t]) * S};
  }
};

}  // namespace

// qdtype: the type of q and out; sdtype: the K/V store (repro::DType codes).
// k_scale/v_scale: null for an unscaled store. Returns as
// repro::launch_attention.
extern "C" int repro_ragged_attention(const void* q, const void* k, const void* v,
                                      const void* k_scale, const void* v_scale,
                                      const void* tok_slot, const void* tok_pos, void* out,
                                      int T, int S, int KV, int G, int D, int window, int qdtype,
                                      int sdtype, void* stream) {
  const RaggedIndex index{static_cast<const int*>(tok_slot), static_cast<const int*>(tok_pos),
                          S};
  return repro::launch_attention(q, k, v, k_scale, v_scale, index, out, T, KV, G, D, window,
                                 qdtype, sdtype, stream);
}
