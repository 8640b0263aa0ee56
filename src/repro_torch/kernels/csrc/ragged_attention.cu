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
// What bounds it on the H100: the K/V bytes (and scale bytes) of the union
// of the real tokens' valid prefixes. Tokens of one prefill chunk share their
// slot's rows, so a chunk of n tokens at positions p..p+n-1 needs the p + n
// rows of its slot once, where one token a block reads ~n (p + n/2).
//
// The design: split_attention.cuh's split-KV body under a dense row policy
// (RaggedSlots, ragged_slots.cuh), as paged packs run over the pool. A pack
// takes tiles of 8 / GC consecutive tokens (ragged_pack.cu at G <= 4; one
// token a tile at G >= 5, where a chunk of 8 group rows fills the block), whose
// rows share every staged K/V row of their slot, a pass per slot where a
// tile spans two; 8 rows of bf16 queries over a bf16, int8 or fp8 store run
// on mma.sync (MmaRows). Each tile's positions split into spans, merged in
// split order. The tile (8 / GC tokens or one), the span and so the splits
// come from host values only (kernels/ragged_attention.py::plan), so a CUDA
// graph can capture the launch.

#include "ragged_slots.cuh"

// qdtype: the type of q and out; sdtype: the K/V store (repro::DType codes).
// k_scale/v_scale: null for an unscaled store. span: positions per split
// (kernels/decode_attention.py::split_span over S positions); tile_tokens: 1
// (one token a tile) or 0 (a pack's tiles: 8 / GC tokens at G <= 4, one
// above); ws: f32 scratch of T * KV * G * splits * (D + 2) elements and
// counters: int32 zeros, one per (tile, KV head, chunk of the group), left
// zero — both may be null when splits == 1. Returns as
// repro::splitkv::launch_split, and -1 for another tile_tokens.
extern "C" int repro_ragged_attention(const void* q, const void* k, const void* v,
                                      const void* k_scale, const void* v_scale,
                                      const void* tok_slot, const void* tok_pos, void* ws,
                                      void* counters, void* out, int T, int S, int KV, int G,
                                      int D, int window, int span, int tile_tokens, int qdtype,
                                      int sdtype, void* stream) {
  using repro::splitkv::RaggedSlots;
  const RaggedSlots slots{static_cast<const int*>(tok_slot), static_cast<const int*>(tok_pos),
                          S};
  if (tile_tokens != 0 && tile_tokens != 1) return -1;
  if (tile_tokens == 1 || G > 4)  // a pack's tile at G >= 5 is one token
    return repro::splitkv::launch_split<false>(q, k, v, k_scale, v_scale, slots, out, ws,
                                               counters, T, S, KV, G, D, window, span, qdtype,
                                               sdtype, stream);
  return repro::splitkv::launch_ragged_pack(q, k, v, k_scale, v_scale, slots, out, ws, counters,
                                            T, S, KV, G, D, window, span, qdtype, sdtype, stream);
}
