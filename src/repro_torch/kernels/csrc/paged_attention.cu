// Packed variable-length attention against a block-paged KV pool, over a
// plain (f32/bf16) or a quantized (int8/fp8 rows + f32 row scales) store.
// It carries both the engine's paged ragged packs and its paged decode
// chunks (a decode is one descriptor per sequence).
//
// Replaces the TPU kernels
// repro/kernels/ragged_attention.py::paged_ragged_attention (_paged_kernel,
// and _paged_kernel_q8 for the quantized store): q [T, KV, G, D], pools
// k/v [NB, bs, KV, D], for a quantized store scale pools k_scale/v_scale
// [NB, bs, KV] f32, per-token descriptors tok_seq/tok_pos [T] int32 and block
// tables [R, max_blocks] int32. Position p of table row r lives at offset
// p % bs of pool block tables[r, p / bs]; key p is valid for token t iff p <=
// tok_pos[t] (and p > tok_pos[t] - window when window > 0). Table entries
// past the pool (the unallocated sentinel NB) are clamped to NB - 1 and never
// inside a real token's range. Padding tokens carry tok_pos >= max_blocks *
// bs and come out as zeros without reading the pool. Returns [T, KV, G, D]
// in q's dtype.
//
// What bounds it on the H100: as the ragged kernel, the K/V bytes (and scale
// bytes) of each real token's valid prefix, plus one 4-byte table entry per
// block of that prefix.
//
// The design: split_attention.cuh's split-KV body with a paged row policy.
// A decode (ops.paged_decode_attention) takes one token a tile, as the
// dense decode; a pack takes tiles of 8 / GC consecutive tokens, whose rows
// share every staged K/V row of their sequence, so a pack reads each
// sequence's prefix once per tile instead of once per token. A block loads
// the table entries of its span (span / bs words) into shared memory once
// and addresses every stage's 16-byte copies from them. The block size bs
// is a runtime argument (the engine uses 8, 16 or 32). The span and the
// tile come from host values only (kernels/paged_attention.py).

#include "paged_table.cuh"

// qdtype: the type of q and out; sdtype: the K/V store (repro::DType codes).
// k_scale/v_scale: null for an unscaled store. span: positions per split
// (kernels/decode_attention.py::split_span over max_blocks * bs positions);
// tile_tokens: 1 (a decode: one token a tile) or 0 (a pack: 8 / GC tokens a
// tile); ws: f32 scratch of T * KV * G * splits * (D + 2) elements and
// counters: int32 zeros, one per (tile, KV head, chunk of the group), left
// zero — both may be null when splits == 1. Returns as
// repro::splitkv::launch_split, and -1 for another tile_tokens.
extern "C" int repro_paged_attention(const void* q, const void* k, const void* v,
                                     const void* k_scale, const void* v_scale,
                                     const void* tok_seq, const void* tok_pos,
                                     const void* tables, void* ws, void* counters, void* out,
                                     int T, int NB, int bs, int max_blocks, int KV, int G, int D,
                                     int window, int span, int tile_tokens, int qdtype,
                                     int sdtype, void* stream) {
  using repro::splitkv::PagedTable;
  const PagedTable table{static_cast<const int*>(tok_seq), static_cast<const int*>(tok_pos),
                         static_cast<const int*>(tables), NB, bs, max_blocks};
  const int S = max_blocks * bs;
  if (tile_tokens != 0 && tile_tokens != 1) return -1;
  if (tile_tokens == 1 || G > 4)  // a pack's tile at G >= 5 is one token, as a decode's
    return repro::splitkv::launch_split<false>(q, k, v, k_scale, v_scale, table, out, ws,
                                               counters, T, S, KV, G, D, window, span, qdtype,
                                               sdtype, stream);
  return repro::splitkv::launch_paged_pack(q, k, v, k_scale, v_scale, table, out, ws, counters,
                                           T, S, KV, G, D, window, span, qdtype, sdtype,
                                           stream);
}
