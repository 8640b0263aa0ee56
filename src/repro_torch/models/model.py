"""The dense decoder LM (the ``dense`` branch of ``repro/models/model.py``).

A pre-norm transformer: RMSNorm -> GQA attention (optional qk-norm, RoPE)
-> residual -> RMSNorm -> SwiGLU -> residual, then final norm and unembed.
Layer params are stacked on a leading ``L`` axis as in the JAX package, and
a Python loop over layers replaces ``lax.scan``. It serves prefill
(:meth:`LM.prefill`), one decode step for every slot (:meth:`LM.decode_step`)
and the packed ragged step of the unified engine (:meth:`LM.packed_step`).

Caches are updated in place (the JAX package donates them instead).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ref as _ref
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import (
    Params,
    dense_init,
    embed_tokens,
    mlp_apply,
    rms_norm,
    trunc_normal,
    unembed,
)


class LM:
    def __init__(self, cfg: ArchConfig, device=None):
        if cfg.family != "dense":
            raise NotImplementedError(f"family {cfg.family!r} is not ported (dense only)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = getattr(torch, cfg.dtype)
        self._views: tuple = (None, [])

    # ------------------------------------------------------------------ init

    def init(self, generator: torch.Generator) -> Params:
        """Random params from ``generator`` (which must live on the model's
        device), in the JAX package's layout with stacked [L, ...] blocks."""
        cfg, dt, dev = self.cfg, self.dtype, self.device
        d, f, L = cfg.d_model, cfg.d_ff, cfg.n_layers
        H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

        def w(shape, fan_in):  # stacked [L, *shape], scaled by the layer's fan-in
            return dense_init((L, *shape), generator, dt, dev, fan_in=fan_in)

        def ones(*shape):
            return torch.ones(shape, dtype=dt, device=dev)

        attn = {
            "wq": w((d, H, hd), d),
            "wk": w((d, KV, hd), d),
            "wv": w((d, KV, hd), d),
            "wo": w((H, hd, d), H * hd),
        }
        if cfg.qk_norm:
            attn["q_norm"] = ones(L, hd)
            attn["k_norm"] = ones(L, hd)
        embed = {"tok": trunc_normal((cfg.vocab_size, d), generator, dt, dev)}
        if not cfg.tie_embeddings:
            embed["head"] = dense_init((d, cfg.vocab_size), generator, dt, dev)
        return {
            "embed": embed,
            "final_norm": ones(d),
            "blocks": {
                "attn": attn,
                "norm1": ones(L, d),
                "norm2": ones(L, d),
                "mlp": {"w_in": w((d, f), d), "w_gate": w((d, f), d), "w_out": w((f, d), f)},
            },
        }

    def init_cache(self, batch: int, max_len: int) -> Params:
        """Zero KV cache {k, v}: [L, B, S_max, KV, hd] each, in the model dtype."""
        cfg = self.cfg
        shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
        return {
            "k": torch.zeros(shape, dtype=self.dtype, device=self.device),
            "v": torch.zeros(shape, dtype=self.dtype, device=self.device),
        }

    def _layers(self, params: Params) -> list[Params]:
        """Per-layer views of the stacked blocks, rebuilt only for new params."""
        if self._views[0] is not params:
            self._views = (params, [_index(params["blocks"], i) for i in range(self.cfg.n_layers)])
        return self._views[1]

    def _mlp_residual(self, blk: Params, x: torch.Tensor) -> torch.Tensor:
        return x + mlp_apply(blk["mlp"], rms_norm(x, blk["norm2"], self.cfg.norm_eps))

    def _logits(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        return unembed(params["embed"], rms_norm(x, params["final_norm"], self.cfg.norm_eps))

    # ---------------------------------------------------------------- prefill

    def prefill(
        self, params: Params, batch: dict, max_len: int,
        cache: Optional[Params] = None, slot: int = 0,
    ) -> tuple[torch.Tensor, Params]:
        """Full-sequence forward that also fills the decode cache.

        batch: {'tokens': [B, S] int}. Returns (logits [B, S, V], cache). With
        ``cache=None`` a zero cache [L, B, max_len, ...] is allocated, as in
        the JAX package; otherwise rows 0..S-1 of slots slot..slot+B-1 of
        ``cache`` are written in place (the engine's fused admission)."""
        cfg = self.cfg
        x = embed_tokens(params["embed"], batch["tokens"])
        b, s = x.shape[:2]
        if s > max_len:
            raise ValueError(f"sequence {s} longer than max_len {max_len}")
        if cache is None:
            cache = self.init_cache(b, max_len)
        positions = torch.arange(s, dtype=torch.int32, device=x.device)
        for li, blk in enumerate(self._layers(params)):
            h = rms_norm(x, blk["norm1"], cfg.norm_eps)
            a, (k, v) = attn_mod.attention_apply(blk["attn"], cfg, h, positions, return_kv=True)
            cache["k"][li, slot:slot + b, :s] = k
            cache["v"][li, slot:slot + b, :s] = v
            x = self._mlp_residual(blk, x + a)
        return self._logits(params, x), cache

    # ------------------------------------------------------------ decode step

    def decode_step(
        self, params: Params, cache: Params, batch: dict, cur_len: torch.Tensor
    ) -> tuple[torch.Tensor, Params]:
        """One token for every slot. batch: {'tokens': [B, 1]}; cur_len: [B]
        int32 tokens already cached. Returns (logits [B, 1, V], cache)."""
        cfg = self.cfg
        x = embed_tokens(params["embed"], batch["tokens"])
        for li, blk in enumerate(self._layers(params)):
            h = rms_norm(x, blk["norm1"], cfg.norm_eps)
            a, _, _ = attn_mod.attention_decode(
                blk["attn"], cfg, h, cache["k"][li], cache["v"][li], cur_len
            )
            x = self._mlp_residual(blk, x + a)
        return self._logits(params, x), cache

    # ------------------------------------------------------------ packed step

    def packed_step(
        self,
        params: Params,
        cache: Params,
        tokens: torch.Tensor,
        tok_slot: torch.Tensor,
        tok_pos: torch.Tensor,
        out_rows: Optional[torch.Tensor] = None,
        pack_slots: Optional[torch.Tensor] = None,
        max_len: Optional[int] = None,
    ) -> tuple[torch.Tensor, Params]:
        """Unified ragged prefill+decode step over one flat [T] token batch,
        each token with its own (cache slot, absolute position).

        tokens/tok_slot/tok_pos: [T] int32. With ``pack_slots`` ([P] int32),
        ``tok_slot`` indexes into it. Padding tokens carry tok_pos >= S_max:
        their cache writes are dropped and their logits rows are garbage.
        ``out_rows`` selects the rows to unembed. ``max_len`` is accepted for
        the JAX signature; only recurrent families need it. Returns (logits
        [T or len(out_rows), V], cache)."""
        del max_len
        cfg = self.cfg
        x = embed_tokens(params["embed"], tokens)
        valid = None
        if x.device.type == "cpu":
            # the plain path's mask depends only on the descriptors: build it
            # once for every layer (the CUDA kernel derives its own)
            glob = tok_slot if pack_slots is None else pack_slots[tok_slot.long()]
            b, s_max = cache["k"].shape[1], cache["k"].shape[2]
            valid = _ref.ragged_valid_mask(glob, tok_pos, b, s_max, cfg.sliding_window)
        for li, blk in enumerate(self._layers(params)):
            h = rms_norm(x, blk["norm1"], cfg.norm_eps)
            a, _, _ = attn_mod.attention_packed(
                blk["attn"], cfg, h, cache["k"][li], cache["v"][li],
                tok_slot, tok_pos, valid, pack_slots,
            )
            x = self._mlp_residual(blk, x + a)
        if out_rows is not None:
            x = x[out_rows.long()]
        return self._logits(params, x), cache


def _index(tree: Params, i: int) -> Params:
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]
