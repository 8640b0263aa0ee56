"""The dense decoder LM (the ``dense`` branch of ``repro/models/model.py``).

A pre-norm transformer: RMSNorm -> GQA attention (optional qk-norm, RoPE),
or multi-head latent attention where the config has ``mla``
(``models.mla``) -> residual -> RMSNorm -> SwiGLU -> residual, then final
norm and unembed.
Layer params are stacked on a leading ``L`` axis as in the JAX package
(an int8 weight's ``{"q8", "scale"}`` sub-dict slices per layer like any
leaf), and a Python loop over layers replaces ``lax.scan``. It serves prefill
(:meth:`LM.prefill`), one decode step for every slot (:meth:`LM.decode_step`)
and the packed ragged step of the unified engine (:meth:`LM.packed_step`).

Caches are updated in place (the JAX package donates them instead). A cache
is dense (:meth:`LM.init_cache`) or a block-paged pool (:meth:`LM.init_kv_pool`,
read through block tables), and either may store quantized rows with
per-(position, head) ``k_scale``/``v_scale`` leaves (``kv_dtype``). An MLA
model's cache is the latent one, ``{"ckv": [L, B, S, kv_lora], "krope":
[L, B, S, rope]}``, dense and unquantized only (``has_positional_kv``).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ref as _ref
from repro_torch.models import attention as attn_mod
from repro_torch.models import mla as mla_mod
from repro_torch.models.layers import (
    Params,
    dense_init,
    embed_tokens,
    mlp_apply,
    rms_norm,
    trunc_normal,
    unembed,
)
from repro_torch.models.quant import layer_matmul_views


class LM:
    def __init__(self, cfg: ArchConfig, device=None):
        if cfg.family != "dense":
            raise NotImplementedError(f"family {cfg.family!r} is not ported (dense, with or "
                                      "without MLA, only)")
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

        if cfg.mla is not None:
            attn = mla_mod.mla_init(cfg, generator, dt, dev)
        else:
            attn = {
                "wq": w((d, H, hd), d),
                "wk": w((d, KV, hd), d),
                "wv": w((d, KV, hd), d),
                "wo": w((H, hd, d), H * hd),
            }
        if cfg.qk_norm and cfg.mla is None:
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

    # ------------------------------------------------------------ capabilities

    @property
    def supports_packed(self) -> bool:
        """Whether the unified ragged prefill+decode dispatch applies: every
        ported family (positional K/V rows, or MLA's latent rows)."""
        return self.cfg.family == "dense"

    @property
    def has_positional_kv(self) -> bool:
        """Whether the cache stores one K/V row per (position, head), the
        precondition for paging and quantized rows. The MLA latent cache is
        positional but latent-shaped: it neither pages nor quantizes."""
        return self.cfg.family == "dense" and self.cfg.mla is None

    @property
    def family_tag(self) -> str:
        """The family for error messages ('dense+mla' when the attention is
        latent)."""
        return f"{self.cfg.family}+mla" if self.cfg.mla is not None else self.cfg.family

    def _kv_leaves(self, lead: tuple, kv_dtype: Optional[torch.dtype]) -> Params:
        """Zero K/V leaves [L, *lead, KV, hd] in the model dtype, or in
        ``kv_dtype`` with all-ones f32 scale leaves [L, *lead, KV]."""
        cfg = self.cfg
        shape = (cfg.n_layers, *lead, cfg.n_kv_heads, cfg.head_dim)
        dt = self.dtype if kv_dtype is None else kv_dtype
        leaves = {
            "k": torch.zeros(shape, dtype=dt, device=self.device),
            "v": torch.zeros(shape, dtype=dt, device=self.device),
        }
        if kv_dtype is not None:
            for name in ("k_scale", "v_scale"):
                leaves[name] = torch.ones(shape[:-1], dtype=torch.float32, device=self.device)
        return leaves

    def init_cache(self, batch: int, max_len: int,
                   kv_dtype: Optional[torch.dtype] = None) -> Params:
        """Zero KV cache {k, v}: [L, B, S_max, KV, hd] each, in the model
        dtype. ``kv_dtype`` (f32, int8 or float8_e4m3fn) stores quantized
        rows instead, with f32 ``k_scale``/``v_scale`` leaves [L, B, S_max,
        KV]; f32 is the identity lane, bit-identical to the plain cache. An
        MLA model's cache is {ckv: [L, B, S_max, kv_lora], krope: [L, B,
        S_max, rope]} in the model dtype; it takes no ``kv_dtype``."""
        if kv_dtype is not None and not self.has_positional_kv:
            raise ValueError(f"family {self.family_tag!r} has no positional KV to quantize")
        if self.cfg.mla is not None:
            m, L = self.cfg.mla, self.cfg.n_layers
            return {
                "ckv": torch.zeros((L, batch, max_len, m.kv_lora_rank), dtype=self.dtype,
                                   device=self.device),
                "krope": torch.zeros((L, batch, max_len, m.rope_head_dim), dtype=self.dtype,
                                     device=self.device),
            }
        return self._kv_leaves((batch, max_len), kv_dtype)

    def init_kv_pool(self, num_blocks: int, block_size: int,
                     kv_dtype: Optional[torch.dtype] = None) -> Params:
        """Zero block-paged pool: [L, num_blocks + 1, block_size, KV, hd]
        per leaf (scale leaves [L, num_blocks + 1, block_size, KV] with
        ``kv_dtype``). Blocks 0..num_blocks-1 are the allocator's; block
        ``num_blocks`` — the tables' unallocated sentinel — is a scratch
        block that takes the writes a sentinel entry drops (see
        ``models.attention``), so no table ever names it. Positional-KV
        families only (``has_positional_kv``)."""
        if not self.has_positional_kv:
            raise ValueError(f"family {self.family_tag!r} has no positional KV to page")
        return self._kv_leaves((num_blocks + 1, block_size), kv_dtype)

    def _layers(self, params: Params) -> list[Params]:
        """Per-layer views of the stacked blocks (int8 leaves as the [K, N]
        weight and [N] scale the matmul kernel takes), rebuilt only for new
        params."""
        views = self._views  # one read: another thread may replace it meanwhile
        if views[0] is not params:
            views = (params, [layer_matmul_views(_index(params["blocks"], i))
                              for i in range(self.cfg.n_layers)])
            self._views = views
        return views[1]

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
        if cache is not None and "k_scale" in cache:
            raise ValueError("prefill writes an unquantized cache; a quantized cache is "
                             "filled through packed_step")
        x = embed_tokens(params["embed"], batch["tokens"])
        b, s = x.shape[:2]
        if s > max_len:
            raise ValueError(f"sequence {s} longer than max_len {max_len}")
        if cache is None:
            cache = self.init_cache(b, max_len)
        positions = torch.arange(s, dtype=torch.int32, device=x.device)
        for li, blk in enumerate(self._layers(params)):
            h = rms_norm(x, blk["norm1"], cfg.norm_eps)
            if cfg.mla is not None:
                a, pieces = mla_mod.mla_apply(blk["attn"], cfg, h, positions, return_kv=True)
                names = ("ckv", "krope")
            else:
                a, pieces = attn_mod.attention_apply(blk["attn"], cfg, h, positions,
                                                     return_kv=True)
                names = ("k", "v")
            for name, piece in zip(names, pieces):
                cache[name][li, slot:slot + b, :s] = piece
            x = self._mlp_residual(blk, x + a)
        return self._logits(params, x), cache

    # ------------------------------------------------------------ decode step

    def _attend(self, fn, mla_fn, li: int, blk: Params, h: torch.Tensor, cache: Params,
                *args, block_tables: Optional[torch.Tensor]) -> torch.Tensor:
        """One layer's attention through ``fn`` (decode or packed) over layer
        ``li`` of the cache, its scale leaves threaded when quantized; an MLA
        model's through ``mla_fn`` over its latent leaves."""
        if self.cfg.mla is not None:
            if block_tables is not None:
                raise ValueError(f"family {self.family_tag!r} has no paged path")
            return mla_fn(blk["attn"], self.cfg, h, cache["ckv"][li], cache["krope"][li],
                          *args)[0]
        scales = {}
        if "k_scale" in cache:
            scales = {"k_scale": cache["k_scale"][li], "v_scale": cache["v_scale"][li]}
        out = fn(blk["attn"], self.cfg, h, cache["k"][li], cache["v"][li], *args,
                 block_tables=block_tables, **scales)
        return out[0]

    def decode_step(
        self, params: Params, cache: Params, batch: dict, cur_len: torch.Tensor,
        block_tables: Optional[torch.Tensor] = None,
    ) -> tuple[torch.Tensor, Params]:
        """One token for every slot. batch: {'tokens': [B, 1]}; cur_len: [B]
        int32 tokens already cached. With ``block_tables`` ([B, max_blocks]
        int32) ``cache`` is a paged pool. Returns (logits [B, 1, V], cache)."""
        cfg = self.cfg
        x = embed_tokens(params["embed"], batch["tokens"])
        for li, blk in enumerate(self._layers(params)):
            h = rms_norm(x, blk["norm1"], cfg.norm_eps)
            a = self._attend(attn_mod.attention_decode, mla_mod.mla_decode, li, blk, h, cache,
                             cur_len, block_tables=block_tables)
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
        block_tables: Optional[torch.Tensor] = None,
        max_len: Optional[int] = None,
    ) -> tuple[torch.Tensor, Params]:
        """Unified ragged prefill+decode step over one flat [T] token batch,
        each token with its own (cache slot, absolute position).

        tokens/tok_slot/tok_pos: [T] int32. With ``pack_slots`` ([P] int32),
        ``tok_slot`` indexes into it. With ``block_tables`` ([B, max_blocks]
        int32) ``cache`` is a paged pool and (slot, pos) resolves to (block,
        offset) through the slot's table row — the same step otherwise, which
        keeps paged and dense serving equal. Padding tokens carry tok_pos >=
        S_max: their cache writes are dropped and their logits rows are
        garbage. ``out_rows`` selects the rows to unembed. ``max_len`` is
        accepted for the JAX signature; only recurrent families need it.
        Returns (logits [T or len(out_rows), V], cache)."""
        del max_len
        cfg = self.cfg
        x = embed_tokens(params["embed"], tokens)
        valid = None
        if x.device.type == "cpu":
            # the plain path's mask depends only on the descriptors: build it
            # once for every layer (the CUDA kernel derives its own)
            glob = tok_slot if pack_slots is None else pack_slots[tok_slot.long()]
            if block_tables is None:  # [L, B, S_max, ...] K rows or MLA latents
                leaf = cache["ckv"] if cfg.mla is not None else cache["k"]
                b, s_max = leaf.shape[1], leaf.shape[2]
            else:  # the tables' dense view: S_max = table width * block size
                b, s_max = block_tables.shape[0], block_tables.shape[1] * cache["k"].shape[2]
            valid = _ref.ragged_valid_mask(glob, tok_pos, b, s_max, cfg.sliding_window)
        for li, blk in enumerate(self._layers(params)):
            h = rms_norm(x, blk["norm1"], cfg.norm_eps)
            a = self._attend(attn_mod.attention_packed, mla_mod.mla_packed, li, blk, h, cache,
                             tok_slot, tok_pos, valid, pack_slots, block_tables=block_tables)
            x = self._mlp_residual(blk, x + a)
        if out_rows is not None:
            x = x[out_rows.long()]
        return self._logits(params, x), cache


def _index(tree: Params, i: int) -> Params:
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]
