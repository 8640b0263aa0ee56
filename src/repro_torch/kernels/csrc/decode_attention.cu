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
//
// Simple design: one block per (slot, KV head, chunk of 1, 4 or 8 rows of the
// group) with the chunk's query rows held in registers, so the cache is
// never expanded G-fold (D and G over attention_common.cuh's domain). The TPU
// grid's sequential S axis becomes a loop inside the block over the valid
// range only (no tile past cur_len or before the window is read). Eight warps
// split that range; each keeps NW*U coalesced row loads in flight and its own
// online softmax in f32, merged once at the end (attention_common.cuh). A
// quantized row is widened in registers (4 int8/fp8 values per 32-bit load at
// D = 128) and its scale folded into the score and the probability weight,
// so no dequantized row is ever stored. Split-K across blocks, cp.async/TMA
// pipelining and tensor cores are later work.

#include "attention_common.cuh"

namespace {

// Token b is slot b's next position cur_len[b]; a position past the cache
// sees the whole slot.
struct DecodeIndex {
  const int* __restrict__ cur_len;
  int S;
  __device__ __forceinline__ void range(int b, int window, int* lo, int* hi) const {
    repro::key_range(cur_len[b], S, window, lo, hi);
  }
  __device__ __forceinline__ repro::DenseRows rows(int b) const {
    return {static_cast<int64_t>(b) * S};
  }
};

}  // namespace

// qdtype: the type of q and out; sdtype: the K/V store (repro::DType codes).
// k_scale/v_scale: null for an unscaled store. Returns as
// repro::launch_attention.
extern "C" int repro_decode_attention(const void* q, const void* k, const void* v,
                                      const void* k_scale, const void* v_scale,
                                      const void* cur_len, void* out, int B, int S, int KV,
                                      int G, int D, int window, int qdtype, int sdtype,
                                      void* stream) {
  const DecodeIndex index{static_cast<const int*>(cur_len), S};
  return repro::launch_attention(q, k, v, k_scale, v_scale, index, out, B, KV, G, D, window,
                                 qdtype, sdtype, stream);
}
