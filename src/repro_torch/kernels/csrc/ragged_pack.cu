// Ragged attention's pack tiles at G <= 4 (8 / GC consecutive tokens a
// block: 8 at G = 1, 2 at G <= 4), compiled apart from ragged_attention.cu's
// one-token tiles; see ragged_attention.cu and split_attention.cuh.

#include "ragged_slots.cuh"

namespace repro {
namespace splitkv {

int launch_ragged_pack(const void* q, const void* k, const void* v, const void* k_scale,
                       const void* v_scale, const RaggedSlots& slots, void* out, void* ws,
                       void* counters, int T, int S, int KV, int G, int D, int window, int span,
                       int qdtype, int sdtype, void* stream) {
  if (G > 4) return -1;
  return launch_split<true>(q, k, v, k_scale, v_scale, slots, out, ws, counters, T, S, KV, G, D,
                            window, span, qdtype, sdtype, stream);
}

}  // namespace splitkv
}  // namespace repro
