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
// Simple design: the ragged kernel (attention_common.cuh's attention_kernel)
// with a paged index: one block per (packed token, KV head, chunk of the
// group). The block reads its own (seq, pos), then walks its valid key range
// in the shared in-block loop with paged addressing: key p reads the table
// entry of block p / bs (one broadcast load, L1-resident for the bs keys of
// the block) and the rows
// at offset p % bs, which are contiguous per head within a block exactly as
// in the dense cache. The block size bs is a runtime argument (the engine
// uses 8, 16 or 32). Quantized rows are widened in registers with their
// scales folded into the math.

#include "attention_common.cuh"

namespace {

// Token t at position tok_pos[t] of table row tok_seq[t]; the row covers
// max_blocks * bs positions.
struct PagedIndex {
  const int* __restrict__ tok_seq;
  const int* __restrict__ tok_pos;
  const int* __restrict__ tables;
  int NB, bs, max_blocks;
  __device__ __forceinline__ void range(int t, int window, int* lo, int* hi) const {
    repro::token_key_range(tok_pos[t], max_blocks * bs, window, lo, hi);
  }
  __device__ __forceinline__ repro::PagedRows rows(int t) const {
    return {tables + static_cast<int64_t>(tok_seq[t]) * max_blocks, bs, NB - 1};
  }
};

}  // namespace

// qdtype: the type of q and out; sdtype: the K/V store (repro::DType codes).
// k_scale/v_scale: null for an unscaled store. Returns as
// repro::launch_attention.
extern "C" int repro_paged_attention(const void* q, const void* k, const void* v,
                                     const void* k_scale, const void* v_scale,
                                     const void* tok_seq, const void* tok_pos,
                                     const void* tables, void* out, int T, int NB, int bs,
                                     int max_blocks, int KV, int G, int D, int window,
                                     int qdtype, int sdtype, void* stream) {
  const PagedIndex index{static_cast<const int*>(tok_seq), static_cast<const int*>(tok_pos),
                         static_cast<const int*>(tables), NB, bs, max_blocks};
  return repro::launch_attention(q, k, v, k_scale, v_scale, index, out, T, KV, G, D, window,
                                 qdtype, sdtype, stream);
}
