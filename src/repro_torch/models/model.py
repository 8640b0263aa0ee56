"""The unified LM over the four families of ``repro/models/model.py``.

* ``dense`` — a pre-norm transformer: RMSNorm -> GQA attention (optional
  qk-norm, RoPE), or multi-head latent attention where the config has
  ``mla`` (``models.mla``) -> residual -> RMSNorm -> SwiGLU -> residual;
* ``moe`` — the same attention, the FFN replaced by routed + shared experts
  (``models.moe``) after ``first_k_dense`` leading dense layers at
  ``dense_ff``;
* ``ssm`` — a Mamba1 stack (``models.ssm``), attention-free;
* ``hybrid`` — a Mamba2 stack with ONE weight-tied attention + MLP block
  (``params["shared"]``, no L axis) run after every ``shared_attn_every``
  Mamba2 layers (zamba2);

then final norm and unembed. Layer params are stacked on a leading ``L``
axis as in the JAX package (``params["blocks"]``; an MoE model's
``params["dense_blocks"]`` then ``params["moe_blocks"]``; an int8 weight's
``{"q8", "scale"}`` sub-dict slices per layer like any leaf), and a Python
loop over layers replaces ``lax.scan``. It serves prefill
(:meth:`LM.prefill`), one decode step for every slot
(:meth:`LM.decode_step`) and the packed ragged step of the unified engine
(:meth:`LM.packed_step`; every family but hybrid).

Caches are updated in place (the JAX package donates them instead). An
attention cache is dense (:meth:`LM.init_cache`) or a block-paged pool
(:meth:`LM.init_kv_pool`, read through block tables), and either may store
quantized rows with per-(position, head) ``k_scale``/``v_scale`` leaves
(``kv_dtype``). An MLA model's cache is the latent one, ``{"ckv": [L, B, S,
kv_lora], "krope": [L, B, S, rope]}``, dense and unquantized only
(``has_positional_kv``). An MoE model's one ``[L, ...]`` cache serves both
stacks: the dense layers take indices ``0..first_k_dense-1``, the MoE layers
the rest. An ssm model's cache is its recurrent state ``{"h": [L, B, ...]
f32, "conv": [L, B, K-1, C]}``; a hybrid's is ``{"mamba": that state,
"attn_k", "attn_v": [n_inv, B, S, KV, hd]}``, one K/V plane per invocation
of the shared block. Neither pages nor quantizes.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ref as _ref
from repro_torch.models import attention as attn_mod
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
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
        if cfg.family not in ("dense", "moe", "ssm", "hybrid"):
            raise ValueError(f"unknown family {cfg.family!r}")
        if cfg.family == "moe" and cfg.moe is None:
            raise ValueError(f"{cfg.name}: family 'moe' needs an MoEConfig (cfg.moe)")
        if cfg.family in ("ssm", "hybrid") and cfg.ssm is None:
            raise ValueError(f"{cfg.name}: family {cfg.family!r} needs an SSMConfig (cfg.ssm)")
        if cfg.family == "hybrid" and (cfg.shared_attn_every <= 0
                                       or cfg.n_layers % cfg.shared_attn_every):
            raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not whole groups of "
                             f"shared_attn_every={cfg.shared_attn_every}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = getattr(torch, cfg.dtype)
        self._views: tuple = (None, [])

    # ------------------------------------------------------------------ init

    def init(self, generator: torch.Generator) -> Params:
        """Random params from ``generator`` (which must live on the model's
        device), in the JAX package's layout with stacked [L, ...] blocks:
        ``blocks`` (an ssm or hybrid model's ``{"mamba", "norm"}``; a
        hybrid's one ``shared`` attention + MLP block beside them, no L
        axis), or an MoE model's ``dense_blocks`` (the first
        ``first_k_dense`` layers, SwiGLU at ``dense_ff``) and
        ``moe_blocks``."""
        cfg, dt, dev = self.cfg, self.dtype, self.device
        d, L = cfg.d_model, cfg.n_layers

        def ones(*shape):
            return torch.ones(shape, dtype=dt, device=dev)

        def stack(n, attn, ffn):
            return {"attn": attn, "norm1": ones(n, d), "norm2": ones(n, d), **ffn}

        # a dense model draws attention, embeddings, then the MLP: the order that
        # keeps its seeded weights what they have been
        attn = self._attn_init(generator, L) if cfg.family == "dense" else None
        embed = {"tok": trunc_normal((cfg.vocab_size, d), generator, dt, dev)}
        if not cfg.tie_embeddings:
            embed["head"] = dense_init((d, cfg.vocab_size), generator, dt, dev)
        params: Params = {"embed": embed, "final_norm": ones(d)}
        if cfg.family == "dense":
            params["blocks"] = stack(L, attn, {"mlp": self._mlp_init(generator, L, cfg.d_ff)})
            return params
        if cfg.family in ("ssm", "hybrid"):
            mamba = ssm_mod.block_fns(cfg).init(cfg, generator, dt, dev, L)
            params["blocks"] = {"mamba": mamba, "norm": ones(L, d)}
            if cfg.family == "hybrid":
                shared = stack(1, self._attn_init(generator, 1),
                               {"mlp": self._mlp_init(generator, 1, cfg.d_ff)})
                params["shared"] = _index(shared, 0)
            return params
        kd = cfg.first_k_dense
        if kd:
            attn = self._attn_init(generator, kd)
            params["dense_blocks"] = stack(
                kd, attn, {"mlp": self._mlp_init(generator, kd, cfg.dense_ff or cfg.d_ff)})
        attn = self._attn_init(generator, L - kd)
        params["moe_blocks"] = stack(
            L - kd, attn, {"moe": moe_mod.moe_init(cfg, generator, dt, dev, L - kd)})
        return params

    def _attn_init(self, generator: torch.Generator, n: int) -> Params:
        """``n`` layers' attention params, stacked [n, ...]."""
        cfg, dt, dev = self.cfg, self.dtype, self.device
        d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        if cfg.mla is not None:
            return mla_mod.mla_init(replace(cfg, n_layers=n), generator, dt, dev)
        attn = {
            "wq": dense_init((n, d, H, hd), generator, dt, dev, fan_in=d),
            "wk": dense_init((n, d, KV, hd), generator, dt, dev, fan_in=d),
            "wv": dense_init((n, d, KV, hd), generator, dt, dev, fan_in=d),
            "wo": dense_init((n, H, hd, d), generator, dt, dev, fan_in=H * hd),
        }
        if cfg.qk_norm:
            attn["q_norm"] = torch.ones(n, hd, dtype=dt, device=dev)
            attn["k_norm"] = torch.ones(n, hd, dtype=dt, device=dev)
        return attn

    def _mlp_init(self, generator: torch.Generator, n: int, d_ff: int) -> Params:
        """``n`` layers' SwiGLU at width ``d_ff``, stacked [n, ...]."""
        d, dt, dev = self.cfg.d_model, self.dtype, self.device
        return {"w_in": dense_init((n, d, d_ff), generator, dt, dev, fan_in=d),
                "w_gate": dense_init((n, d, d_ff), generator, dt, dev, fan_in=d),
                "w_out": dense_init((n, d_ff, d), generator, dt, dev, fan_in=d_ff)}

    # ------------------------------------------------------------ capabilities

    @property
    def supports_packed(self) -> bool:
        """Whether the unified ragged prefill+decode dispatch applies: dense
        and moe (positional K/V rows, or MLA's latent rows) and ssm (a
        state-passing chunk of one slot a pack). A hybrid interleaves its
        recurrent state with a shared attention cache and keeps the
        exact-length prefill + decode path (the engine's legacy tier)."""
        return self.cfg.family in ("dense", "moe", "ssm")

    @property
    def has_positional_kv(self) -> bool:
        """Whether the cache stores one K/V row per (position, head), the
        precondition for paging and quantized rows. The MLA latent cache is
        positional but latent-shaped, and SSM state is constant-size: neither
        pages nor quantizes."""
        return self.cfg.family in ("dense", "moe") and self.cfg.mla is None

    @property
    def family_tag(self) -> str:
        """The family for error messages ('dense+mla', 'moe+mla' when the
        attention is latent)."""
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
        S_max, rope]} in the model dtype; it takes no ``kv_dtype``. An ssm
        model's is its state {h: [L, B, ...] f32, conv: [L, B, K-1, C]}, a
        hybrid's {mamba: that state, attn_k, attn_v: [n_inv, B, S_max, KV,
        hd]}."""
        if kv_dtype is not None and not self.has_positional_kv:
            raise ValueError(f"family {self.family_tag!r} has no positional KV to quantize")
        cfg = self.cfg
        if cfg.family in ("ssm", "hybrid"):  # SSM states stay in f32, conv rows in the dtype
            one = ssm_mod.block_fns(cfg).init_cache(cfg, batch, self.dtype, self.device)
            state = {k: v.new_zeros((cfg.n_layers, *v.shape)) for k, v in one.items()}
            if cfg.family == "ssm":
                return state
            shape = (cfg.n_layers // cfg.shared_attn_every, batch, max_len, cfg.n_kv_heads,
                     cfg.head_dim)
            return {"mamba": state,
                    "attn_k": torch.zeros(shape, dtype=self.dtype, device=self.device),
                    "attn_v": torch.zeros(shape, dtype=self.dtype, device=self.device)}
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
        """Per-layer views of the stacked blocks in cache order (an MoE
        model's dense blocks, then its MoE blocks; int8 leaves as the [K, N]
        weight and [N] scale the matmul kernel takes), rebuilt only for new
        params. A hybrid's shared block has no L axis and is read as it is."""
        views = self._views  # one read: another thread may replace it meanwhile
        if views[0] is not params:
            stacks = ([params["blocks"]] if "blocks" in params else
                      [params[k] for k in ("dense_blocks", "moe_blocks") if k in params])
            views = (params, [layer_matmul_views(_index(st, i)) for st in stacks
                              for i in range(_depth(st))])
            self._views = views
        return views[1]

    def _mlp_residual(self, blk: Params, x: torch.Tensor) -> torch.Tensor:
        """x + the layer's SwiGLU, or its MoE block. The MoE block routes
        every token of ``x`` in one call (capacity depends on that count:
        see ``moe.moe_dispatch``) and drops the aux loss, which serving never
        reads."""
        h = rms_norm(x, blk["norm2"], self.cfg.norm_eps)
        if "moe" in blk:
            return x + moe_mod.moe_apply(blk["moe"], self.cfg, h, aux=False)[0]
        return x + mlp_apply(blk["mlp"], h)

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
        if cfg.family in ("ssm", "hybrid"):
            return self._logits(params, self._recurrent_prefill(params, x, positions, cache,
                                                                slot)), cache
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

    def _shared_every(self, li: int) -> Optional[int]:
        """The shared block's invocation that follows layer ``li`` of a
        hybrid stack (after every ``shared_attn_every`` Mamba2 layers), else
        None."""
        every = self.cfg.shared_attn_every
        if self.cfg.family == "hybrid" and (li + 1) % every == 0:
            return li // every
        return None

    def _recurrent_prefill(self, params: Params, x: torch.Tensor, positions: torch.Tensor,
                           cache: Params, slot: int) -> torch.Tensor:
        """An ssm or hybrid stack over the full sequence x [B, S, d], writing
        each Mamba layer's final state, and each shared-block invocation's
        K/V rows 0..S-1, into slots slot..slot+B-1 of ``cache``."""
        cfg = self.cfg
        b, s = x.shape[:2]
        apply = ssm_mod.block_fns(cfg).apply
        state = cache if cfg.family == "ssm" else cache["mamba"]
        for li, blk in enumerate(self._layers(params)):
            out, st = apply(blk["mamba"], cfg, rms_norm(x, blk["norm"], cfg.norm_eps),
                            return_state=True)
            for name, piece in st.items():
                state[name][li, slot:slot + b] = piece
            x = x + out
            g = self._shared_every(li)
            if g is not None:
                shared = params["shared"]
                h = rms_norm(x, shared["norm1"], cfg.norm_eps)
                a, (k, v) = attn_mod.attention_apply(shared["attn"], cfg, h, positions,
                                                     return_kv=True)
                cache["attn_k"][g, slot:slot + b, :s] = k
                cache["attn_v"][g, slot:slot + b, :s] = v
                x = self._mlp_residual(shared, x + a)
        return x

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
        block_tables: Optional[torch.Tensor] = None, active: Optional[torch.Tensor] = None,
    ) -> tuple[torch.Tensor, Params]:
        """One token for every slot. batch: {'tokens': [B, 1]}; cur_len: [B]
        int32 tokens already cached. With ``block_tables`` ([B, max_blocks]
        int32) ``cache`` is a paged pool. ``active`` ([B], ssm and hybrid)
        names the slots whose recurrent state the step advances; the others
        keep theirs (None: every slot). Returns (logits [B, 1, V], cache)."""
        cfg = self.cfg
        if block_tables is not None and cfg.family in ("ssm", "hybrid"):
            raise ValueError(f"family {self.family_tag!r} has no paged path")
        x = embed_tokens(params["embed"], batch["tokens"])
        if cfg.family in ("ssm", "hybrid"):
            return self._logits(params, self._recurrent_decode(params, cache, x, cur_len,
                                                               active)), cache
        for li, blk in enumerate(self._layers(params)):
            h = rms_norm(x, blk["norm1"], cfg.norm_eps)
            a = self._attend(attn_mod.attention_decode, mla_mod.mla_decode, li, blk, h, cache,
                             cur_len, block_tables=block_tables)
            x = self._mlp_residual(blk, x + a)
        return self._logits(params, x), cache

    def _recurrent_decode(self, params: Params, cache: Params, x: torch.Tensor,
                          cur_len: torch.Tensor, active: Optional[torch.Tensor]) -> torch.Tensor:
        """One token through an ssm or hybrid stack, x [B, 1, d]: each Mamba
        layer's new state written back (where ``active``), each shared-block
        invocation attending its own K/V plane."""
        cfg = self.cfg
        decode = ssm_mod.block_fns(cfg).decode
        state = cache if cfg.family == "ssm" else cache["mamba"]
        keep = None if active is None else active.bool()
        for li, blk in enumerate(self._layers(params)):
            out, new = decode(blk["mamba"], cfg, rms_norm(x, blk["norm"], cfg.norm_eps),
                              {name: leaf[li] for name, leaf in state.items()})
            for name, leaf in new.items():
                dst = state[name][li]
                if keep is not None:
                    leaf = torch.where(keep.view(-1, *([1] * (leaf.ndim - 1))), leaf, dst)
                dst.copy_(leaf)
            x = x + out
            g = self._shared_every(li)
            if g is not None:
                shared = params["shared"]
                h = rms_norm(x, shared["norm1"], cfg.norm_eps)
                a = attn_mod.attention_decode(shared["attn"], cfg, h, cache["attn_k"][g],
                                              cache["attn_v"][g], cur_len)[0]
                x = self._mlp_residual(shared, x + a)
        return x

    def _ssm_packed(self, params: Params, cache: Params, x: torch.Tensor,
                    tok_pos: torch.Tensor, pack_slots: torch.Tensor, max_len: int) -> torch.Tensor:
        """A single-slot pack of the ssm family: x [T, d] is ONE contiguous
        chunk of slot ``pack_slots[0]``'s stream (ascending positions, bucket
        padding after the real rows at ``tok_pos >= max_len``). Each layer
        gathers that slot's (h, conv) state, runs the state-passing chunk and
        writes the state back. A chunk that starts at position 0 starts from
        zeros (a fresh sequence), so admission needs no separate wipe. All on
        the device: no host sync."""
        cfg = self.cfg
        packed = ssm_mod.block_fns(cfg).packed
        slot = pack_slots[:1].long()
        n_real = (tok_pos < max_len).sum()
        fresh = tok_pos[0] == 0
        xb = x[None]
        for li, blk in enumerate(self._layers(params)):
            sl = {}
            for name, leaf in cache.items():
                rows = leaf[li].index_select(0, slot)
                sl[name] = torch.where(fresh, torch.zeros((), dtype=rows.dtype,
                                                          device=rows.device), rows)
            out, new = packed(blk["mamba"], cfg, rms_norm(xb, blk["norm"], cfg.norm_eps), sl,
                              n_real)
            for name, leaf in new.items():
                cache[name][li].index_copy_(0, slot, leaf.to(cache[name].dtype))
            xb = xb + out
        return xb[0]

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
        garbage. ``out_rows`` selects the rows to unembed.

        An ssm pack carries ONE slot (``pack_slots[0]``; the engine packs
        recurrent-state admissions one slot a pack): the whole [T] batch is
        one contiguous chunk of that slot's stream, and ``max_len`` is
        required, since ``tok_pos >= max_len`` marks the padding rows that
        must be state identities. A hybrid model has no packed step.
        Returns (logits [T or len(out_rows), V], cache)."""
        cfg = self.cfg
        if not self.supports_packed:
            raise ValueError(f"family {self.family_tag!r} has no packed path")
        x = embed_tokens(params["embed"], tokens)
        if cfg.family == "ssm":
            if block_tables is not None:
                raise ValueError("SSM state is never paged")
            if max_len is None or pack_slots is None:
                raise ValueError("an SSM pack needs max_len and pack_slots")
            x = self._ssm_packed(params, cache, x, tok_pos, pack_slots, max_len)
            if out_rows is not None:
                x = x[out_rows.long()]
            return self._logits(params, x), cache
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


def _depth(tree: Params) -> int:
    """The stacked L of a block stack (its norm1, or a Mamba stack's norm,
    leaf's leading axis)."""
    return tree["norm1" if "norm1" in tree else "norm"].shape[0]
