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
loop over layers replaces ``lax.scan``. It trains (:meth:`LM.forward`, the
differentiable full-sequence forward, every family) and serves prefill
(:meth:`LM.prefill`), one decode step for every slot
(:meth:`LM.decode_step`) and the packed ragged step of the unified engine
(:meth:`LM.packed_step`; every family but hybrid).

``LM(cfg, mesh_info=info)`` over a ``(data=1, model=N)`` lane mesh with N
>= 2 (``dist.sharding.serving_mesh_info``) is the merged view, one engine
over N lanes (the paper's merge mode: one controller driving every vector
unit): attention heads, MLP width and the vocabulary are split over the
lanes (params placed by ``serve.backend.ShardedBackend``), each lane runs
its part, its own kernels over its own cache shard, on its own stream, and
the partial sums meet on the first lane, the controller's, which holds the
residual stream and the logits. One thread issues every lane's work. It
takes the dense family, GQA or MHA, at any head grouping whose KV heads
divide over the lanes (:func:`check_tensor_parallel`). Its :meth:`LM.forward`
trains, differentiable through the lane collectives. A view with several
data rows trains through ``train.make_train_step(model, tcfg,
mesh_info=view)``, which runs each row on one lane (:meth:`LM.forward_rows`,
every family) or on a merged view of its own (the dense family).

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

import contextlib
from dataclasses import replace
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.common.tree import tree_map_with_path
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.dist import collectives
from repro_torch.dist.sharding import (
    MODEL_AXIS,
    MeshInfo,
    NamedSharding,
    P,
    ShardedTensor,
    lane_blocks,
    recompute_in_lane,
    serve_cache_shardings,
    stream_scope,
)
from repro_torch.kernels import ref as _ref
from repro_torch.models import attention as attn_mod
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    Params,
    dense_init,
    embed_tokens,
    embed_tokens_lanes,
    mlp_apply,
    mlp_apply_lanes,
    rms_norm,
    trunc_normal,
    unembed,
    unembed_lanes,
)
from repro_torch.models.quant import layer_matmul_views

_TP_REFUSED = "under MERGE is not ported (ROADMAP Queue 1 item 7)"
_TP_TRAIN_REFUSED = "in tensor-parallel training is not ported (ROADMAP Queue 1 item 10)"


def check_tensor_parallel(cfg: ArchConfig, model_size: int, training: bool = False) -> None:
    """Raise ``NotImplementedError`` (naming ROADMAP) unless ``cfg`` serves
    (or, ``training``, trains) head-sharded over ``model_size`` lanes: the
    dense family with plain attention, whose KV heads, MLP width and
    vocabulary divide over the lanes. A latent (MLA) cache shards on its
    rank, MoE would take JAX's expert-parallel ``shard_map``, and KV heads
    that do not divide take JAX's head_dim fallback, where GSPMD reduces the
    scores: a per-lane kernel cannot."""
    if model_size <= 1:
        return
    why = _TP_TRAIN_REFUSED if training else _TP_REFUSED
    if cfg.family != "dense":
        raise NotImplementedError(f"{cfg.name}: the {cfg.family} family {why}")
    if cfg.mla is not None:
        raise NotImplementedError(f"{cfg.name}: multi-head latent attention {why}")
    for what, n in (("KV heads", cfg.n_kv_heads), ("d_ff", cfg.d_ff),
                    ("vocab_size", cfg.vocab_size)):
        if n % model_size:
            raise NotImplementedError(f"{cfg.name}: {what} {n} over {model_size} lanes "
                                      f"(JAX's head_dim / uneven fallback) {why}")


def _lane_spec(path: tuple) -> P:
    """The block of a parameter leaf one lane of the merged view computes
    with: its heads of wq/wk/wv [L, d, heads, hd] and of wo [L, H, hd, d],
    its columns of w_in/w_gate and rows of w_out, its rows of the vocabulary;
    norms whole (the controller lane applies them)."""
    name = path[-1]
    if name in ("wq", "wk", "wv"):
        return P(None, None, MODEL_AXIS, None)
    if name == "wo":
        return P(None, MODEL_AXIS, None, None)
    if name in ("w_in", "w_gate"):
        return P(None, None, MODEL_AXIS)
    if name == "w_out":
        return P(None, MODEL_AXIS, None)
    if name == "tok":
        return P(MODEL_AXIS, None)
    if name == "head":
        return P(None, MODEL_AXIS)
    return P()


def _pick(tree, j: int):
    """Lane j's entry of a tree whose leaves are per-lane lists."""
    if isinstance(tree, dict):
        return {k: _pick(v, j) for k, v in tree.items()}
    return tree[j]


class LM:
    def __init__(self, cfg: ArchConfig, device=None, mesh_info: Optional[MeshInfo] = None):
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
        self.mesh_info = mesh_info
        if mesh_info is not None:
            if mesh_info.data_size != 1:
                raise ValueError(f"a merged LM is one (data=1, model=N) view, got "
                                 f"{mesh_info.mesh.shape} (a view of several data rows "
                                 "trains through train.make_train_step(..., mesh_info=))")
            check_tensor_parallel(cfg, mesh_info.model_size)
            root = mesh_info.mesh.lanes[0].device
            if device is not None and resolve_device(device) != root:
                raise ValueError(f"device={device} is not the mesh's first lane's {root}")
            device = root
        self.device = resolve_device(device)
        self.dtype = getattr(torch, cfg.dtype)
        # the KV / latent cache's storage (JAX's cache_dtype); SSM states keep theirs
        self.cache_dtype = getattr(torch, cfg.kv_cache_dtype or cfg.dtype)
        self._views: tuple = (None, [])
        if self.merged:
            n = mesh_info.model_size
            self._lanes = mesh_info.mesh.lanes
            # each lane's attention sees its share of the heads, G per KV head
            self._lcfg = replace(cfg, n_heads=cfg.n_heads // n, n_kv_heads=cfg.n_kv_heads // n,
                                 d_head=cfg.head_dim)
            self._lane_views_of: tuple = (None, None, None)

    @property
    def merged(self) -> bool:
        """Whether this is the merged (tensor-parallel) view over two or more
        lanes."""
        return self.mesh_info is not None and self.mesh_info.model_size > 1

    # ------------------------------------------------------------------ init

    def param_specs(self) -> Params:
        """The tree :meth:`init` builds, its shapes and dtypes, as empty
        ``meta`` tensors: nothing is drawn or allocated (JAX's
        ``param_specs``, the dry run's stand-ins)."""
        return LM(self.cfg, device="meta").init(None)

    def init(self, generator: Optional[torch.Generator]) -> Params:
        """Random params from ``generator`` (which must live on the model's
        device; None on ``meta``, where nothing is drawn), in the JAX
        package's layout with stacked [L, ...] blocks:
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
        dt = self.cache_dtype if kv_dtype is None else kv_dtype
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
        if self.merged:
            return self._lane_kv((batch, max_len), kv_dtype)
        cfg = self.cfg
        if cfg.family in ("ssm", "hybrid"):  # SSM states stay in f32, conv rows in the dtype
            one = ssm_mod.block_fns(cfg).init_cache(cfg, batch, self.dtype, self.device)
            state = {k: v.new_zeros((cfg.n_layers, *v.shape)) for k, v in one.items()}
            if cfg.family == "ssm":
                return state
            shape = (cfg.n_layers // cfg.shared_attn_every, batch, max_len, cfg.n_kv_heads,
                     cfg.head_dim)
            return {"mamba": state,
                    "attn_k": torch.zeros(shape, dtype=self.cache_dtype, device=self.device),
                    "attn_v": torch.zeros(shape, dtype=self.cache_dtype, device=self.device)}
        if self.cfg.mla is not None:
            m, L = self.cfg.mla, self.cfg.n_layers
            return {
                "ckv": torch.zeros((L, batch, max_len, m.kv_lora_rank), dtype=self.cache_dtype,
                                   device=self.device),
                "krope": torch.zeros((L, batch, max_len, m.rope_head_dim), dtype=self.cache_dtype,
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
        if self.merged:
            return self._lane_kv((num_blocks + 1, block_size), kv_dtype)
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

    # --------------------------------------------------------------- training

    def forward(self, params: Params, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence training forward, every family, differentiable end to
        end: attention through ``attention_apply`` / ``mla_apply`` without
        ``return_kv`` (chunked or dense by ``cfg.attn_impl``, plain torch) and
        no hand-written kernel on the way, as the JAX package keeps its
        training forward off Pallas.

        batch: {'tokens': [B, S] int} or {'embeds': [B, S, d]} (an audio or
        vision front end's frames). Returns (logits [B, S, V], aux: the MoE
        load-balance losses summed over the MoE layers, f32; 0 elsewhere).
        With ``cfg.remat == 'block'`` each block (a hybrid: each group of
        ``shared_attn_every`` Mamba2 layers and the shared block after it, as
        the JAX scan body) is recomputed in backward
        (``torch.utils.checkpoint``), so only its input is kept. JAX's
        sequence-parallel and vocab-sharded logits constraints are no-ops on
        one lane and have no counterpart here.

        On the merged view (the dense family over a (data=1, model=N) view,
        params placed by ``serve_param_shardings``) each lane runs its heads,
        its MLP columns and its vocabulary rows on its stream, differentiable
        through the lane collectives; the logits land whole on the first
        lane."""
        if self.merged:
            return self._merged_forward(params, batch)
        return self.forward_rows([params], [batch])[0]

    def forward_rows(self, params: list, batches: list, lanes: Optional[list] = None,
                     whole: bool = False, gather: Optional[Callable] = None
                     ) -> list[tuple[torch.Tensor, torch.Tensor]]:
        """:meth:`forward` for data rows run side by side, block by block:
        row r's params (plain tensors) and batch on ``lanes[r]``, its work on
        that lane's stream. Rows are independent, except that an MoE layer
        routes every row's tokens as one batch (``moe.share_routes``: the
        capacity and the aux loss's fractions of the whole, as JAX routes a
        data-parallel batch), so the MoE blocks of a row split in two under
        remat (the attention, then the routed block); ``whole`` (every row
        holds the whole batch: it did not divide over the rows) routes each
        row alone. One (logits, aux) a row; one row is the one-lane
        forward.

        ``gather`` (ZeRO-3, every family but moe: each row holds a block of
        some leaves) is ``gather(name, blks) -> blks``: each row's entry
        ``name`` of the params (a layer of the stack ``name``, or ``""`` for
        the top-level entries) with those leaves made whole on the row's
        lane. The embedding, final norm and a hybrid's shared block (each
        read more than once or outside the layers, as JAX's scan closes over
        them) are gathered once; each layer (a hybrid: each group of Mamba
        layers) is one rematerialised block over every row that gathers its
        params inside, so they are whole only while the block runs (again in
        the recompute), and the gather's backward hands the grads back."""
        cfg = self.cfg
        n = len(params)
        lanes = [None] * n if lanes is None else lanes

        def on(r):
            return _in_lane(lanes[r])

        if gather is not None:
            if cfg.family == "moe":
                raise NotImplementedError(f"{cfg.name}: ZeRO-3 of the moe family is not "
                                          "ported (ROADMAP Queue 1 item 12)")
            top = [k for k in ("embed", "final_norm", "shared") if k in params[0]]
            tops = gather("", [{k: p[k] for k in top} for p in params])
            params = [dict(p, **t) for p, t in zip(params, tops)]

        def blocks(fn, name, i, *extra):
            """Block ``i`` of the stack ``name``, ``fn(blk, x, *extra)``, for
            every row on its lane."""
            blks = [_index(p[name], i) for p in params]
            if gather is None:
                for r in range(n):
                    with on(r):
                        xs[r] = self._remat(fn, blks[r], xs[r], *[e[r] for e in extra])
            else:
                xs[:] = self._remat(self._gathered_rows, fn, gather, name, blks, list(xs),
                                    lanes, *extra)

        xs, pos, auxs = [], [], [[] for _ in range(n)]
        for r in range(n):
            with on(r):
                x = self._embed(params[r], batches[r])
                xs.append(x)
                pos.append(torch.arange(x.shape[1], dtype=torch.int32, device=x.device))
        if cfg.family in ("dense", "moe"):
            for name in ("blocks", "dense_blocks", "moe_blocks"):
                for i in range(_depth(params[0][name]) if name in params[0] else 0):
                    blks = [_index(p[name], i) for p in params]
                    if "moe" not in blks[0]:
                        blocks(self._dense_block, name, i, pos)
                        continue
                    if n == 1 or whole:
                        for r in range(n):
                            with on(r):
                                xs[r], aux = self._remat(self._moe_block, blks[r], xs[r],
                                                         pos[r])
                            auxs[r].append(aux)
                        continue
                    for r in range(n):
                        with on(r):
                            xs[r] = self._remat(self._train_attn, blks[r], xs[r], pos[r])
                    hs = []
                    for r in range(n):
                        with on(r), torch.no_grad():
                            hs.append(rms_norm(xs[r], blks[r]["norm2"], cfg.norm_eps))
                    shares = moe_mod.share_routes([b["moe"]["router"] for b in blks], hs, cfg,
                                                  lanes)
                    for r in range(n):
                        with on(r):
                            xs[r], aux = self._remat(self._moe_part, blks[r], xs[r], shares[r])
                        auxs[r].append(aux)
        elif cfg.family == "ssm":
            for i in range(cfg.n_layers):
                blocks(self._mamba_block, "blocks", i)
        else:  # hybrid
            every = cfg.shared_attn_every
            for g in range(cfg.n_layers // every):
                if gather is not None:
                    groups = [[_index(p["blocks"], i) for i in range(g * every, (g + 1) * every)]
                              for p in params]
                    xs[:] = self._remat(self._gathered_group, gather, groups,
                                        [p["shared"] for p in params], list(xs), lanes, pos)
                    continue
                for r in range(n):
                    group = [_index(params[r]["blocks"], i)
                             for i in range(g * every, (g + 1) * every)]
                    with on(r):
                        xs[r] = self._remat(self._hybrid_group, group, params[r]["shared"],
                                            xs[r], pos[r])
        out = []
        for r in range(n):
            with on(r):
                aux = (torch.stack(auxs[r]).sum() if auxs[r]
                       else torch.zeros((), dtype=torch.float32, device=xs[r].device))
                out.append((self._logits(params[r], xs[r]), aux))
        return out

    @staticmethod
    def _gathered_rows(fn, gather, name: str, blks: list, xs: list, lanes: list, *extra
                       ) -> tuple:
        """ZeRO-3's block over every row (rematerialised as one): the rows'
        params of ``name`` gathered whole, then ``fn`` on each row's lane."""
        out = []
        for r, (blk, x) in enumerate(zip(gather(name, blks), xs)):
            with _in_lane(lanes[r]):
                out.append(fn(blk, x, *[e[r] for e in extra]))
        return tuple(out)

    def _gathered_group(self, gather, groups: list, shared: list, xs: list, lanes: list,
                        pos: list) -> tuple:
        """ZeRO-3's hybrid group over every row: each layer's params gathered
        whole, then the group and the (gathered) shared block on each row's
        lane."""
        layers = [gather("blocks", [grp[k] for grp in groups]) for k in range(len(groups[0]))]
        out = []
        for r, x in enumerate(xs):
            with _in_lane(lanes[r]):
                out.append(self._hybrid_group([lay[r] for lay in layers], shared[r], x, pos[r]))
        return tuple(out)

    def _embed(self, params: Params, batch: dict) -> torch.Tensor:
        """x [B, S, d]: ``batch["embeds"]`` in the model dtype (an audio or
        vision front end's frames), else the token embedding."""
        if "embeds" in batch:
            return batch["embeds"].to(self.dtype)
        return embed_tokens(params["embed"], batch["tokens"])

    def _remat(self, fn, *args):
        """``fn(*args)``, recomputed in backward under ``cfg.remat == 'block'``
        (nothing of the block's inside is kept across blocks)."""
        if self.cfg.remat == "block" and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False,
                              context_fn=recompute_in_lane)
        return fn(*args)

    def _train_attn(self, blk: Params, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        """x + the block's attention (GQA or MLA) over its pre-norm."""
        cfg = self.cfg
        h = rms_norm(x, blk["norm1"], cfg.norm_eps)
        if cfg.mla is not None:
            return x + mla_mod.mla_apply(blk["attn"], cfg, h, positions)
        return x + attn_mod.attention_apply(blk["attn"], cfg, h, positions)

    def _dense_block(self, blk: Params, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        x = self._train_attn(blk, x, positions)
        return x + mlp_apply(blk["mlp"], rms_norm(x, blk["norm2"], self.cfg.norm_eps))

    def _moe_block(self, blk: Params, x: torch.Tensor, positions: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        """The attention, then the MoE block over every token of the call
        (capacity from B·S) with its aux loss."""
        return self._moe_part(blk, self._train_attn(blk, x, positions))

    def _moe_part(self, blk: Params, x: torch.Tensor,
                  share: Optional[moe_mod.RouteShare] = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
        """x + the MoE block over its pre-norm, with its aux loss (``share``:
        routed as one row of a batch)."""
        out, aux = moe_mod.moe_apply(blk["moe"], self.cfg,
                                     rms_norm(x, blk["norm2"], self.cfg.norm_eps), aux=True,
                                     share=share)
        return x + out, aux

    def _mamba_block(self, blk: Params, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        apply = ssm_mod.block_fns(cfg).apply
        return x + apply(blk["mamba"], cfg, rms_norm(x, blk["norm"], cfg.norm_eps))

    def _hybrid_group(self, group: list, shared: Params, x: torch.Tensor,
                      positions: torch.Tensor) -> torch.Tensor:
        for blk in group:
            x = self._mamba_block(blk, x)
        return self._dense_block(shared, x, positions)

    # ---------------------------------------------------------------- prefill

    def prefill(
        self, params: Params, batch: dict, max_len: int,
        cache: Optional[Params] = None, slot: int = 0,
    ) -> tuple[torch.Tensor, Params]:
        """Full-sequence forward that also fills the decode cache.

        batch: {'tokens': [B, S] int} or {'embeds': [B, S, d]}. Returns
        (logits [B, S, V], cache). With ``cache=None`` a zero cache [L, B,
        max_len, ...] is allocated, as in the JAX package; otherwise rows
        0..S-1 of slots slot..slot+B-1 of ``cache`` are written in place (the
        engine's fused admission)."""
        cfg = self.cfg
        if cache is not None and "k_scale" in cache:
            raise ValueError("prefill writes an unquantized cache; a quantized cache is "
                             "filled through packed_step")
        if self.merged:
            return self._merged_prefill(params, batch, max_len, cache, slot)
        x = self._embed(params, batch)
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
        """One token for every slot. batch: {'tokens': [B, 1]} or {'embeds':
        [B, 1, d]}; cur_len: [B] int32 tokens already cached. With
        ``block_tables`` ([B, max_blocks] int32) ``cache`` is a paged pool.
        ``active`` ([B], ssm and hybrid) names the slots whose recurrent
        state the step advances; the others keep theirs (None: every slot).
        Returns (logits [B, 1, V], cache)."""
        cfg = self.cfg
        if block_tables is not None and cfg.family in ("ssm", "hybrid"):
            raise ValueError(f"family {self.family_tag!r} has no paged path")
        if self.merged:
            return self._merged_step(params, cache, batch, block_tables,
                                     attn_mod.attention_decode, (cur_len,))
        x = self._embed(params, batch)
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
        if self.merged:
            valid = self._valid_mask(cache, tok_slot, tok_pos, pack_slots, block_tables)
            return self._merged_step(params, cache, {"tokens": tokens}, block_tables,
                                     attn_mod.attention_packed,
                                     (tok_slot, tok_pos, valid, pack_slots), out_rows)
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
        valid = self._valid_mask(cache, tok_slot, tok_pos, pack_slots, block_tables)
        for li, blk in enumerate(self._layers(params)):
            h = rms_norm(x, blk["norm1"], cfg.norm_eps)
            a = self._attend(attn_mod.attention_packed, mla_mod.mla_packed, li, blk, h, cache,
                             tok_slot, tok_pos, valid, pack_slots, block_tables=block_tables)
            x = self._mlp_residual(blk, x + a)
        if out_rows is not None:
            x = x[out_rows.long()]
        return self._logits(params, x), cache


    def _valid_mask(self, cache: Params, tok_slot: torch.Tensor, tok_pos: torch.Tensor,
                    pack_slots: Optional[torch.Tensor], block_tables: Optional[torch.Tensor]
                    ) -> Optional[torch.Tensor]:
        """The plain path's ragged mask on the CPU, built once for every layer
        from the descriptors alone (the CUDA kernel derives its own: None)."""
        if self.device.type != "cpu":
            return None
        glob = tok_slot if pack_slots is None else pack_slots[tok_slot.long()]
        if block_tables is None:  # [L, B, S_max, ...] K rows or MLA latents
            leaf = cache["ckv"] if self.cfg.mla is not None else cache["k"]
            b, s_max = leaf.shape[1], leaf.shape[2]
        else:  # the tables' dense view: S_max = table width * block size
            b, s_max = block_tables.shape[0], block_tables.shape[1] * cache["k"].shape[2]
        return _ref.ragged_valid_mask(glob, tok_pos, b, s_max, self.cfg.sliding_window)

    # ------------------------------------------------ the merged (TP) view

    def _lane_kv(self, lead: tuple, kv_dtype: Optional[torch.dtype]) -> Params:
        """Zero K/V leaves [L, *lead, KV, hd] laid over the lanes as
        ``serve_cache_shardings`` says (KV heads on the ``model`` axis;
        slots, positions and blocks never split), each lane's shard made on
        its stream."""
        if kv_dtype is not None:
            raise NotImplementedError(f"a quantized KV cache {_TP_REFUSED}")
        cfg = self.cfg
        shape = (cfg.n_layers, *lead, cfg.n_kv_heads, cfg.head_dim)
        meta = {"k": torch.empty(shape, device="meta"), "v": torch.empty(shape, device="meta")}
        out = {}
        for name, sharding in serve_cache_shardings(meta, self.mesh_info).items():
            shards = []
            for lane, block in zip(self._lanes, sharding.blocks(shape)):
                with lane.use():
                    shards.append(torch.zeros([b - a for a, b in block], dtype=self.cache_dtype,
                                              device=lane.device))
            out[name] = ShardedTensor(shape, self.cache_dtype, sharding, shards)
        return out

    def _lane_params(self, params: Params, train: bool = False
                     ) -> tuple[list[Params], list[list[Params]]]:
        """(each lane's top-level params, each lane's per-layer views) of the
        placed params: every leaf's block of ``_lane_spec`` on each lane. To
        serve, rebuilt only for new params: a view of the lane's shard, or a
        contiguous copy made once where the placement replicated the leaf
        (every leaf under ``MIN_SHARD_ELEMS``) or split another dim. To train
        (``train``), views only, built anew under autograd: each lane's block
        of its own shard, so a replicated leaf's grad lands on every replica
        in parts (each lane's block; the norms on the first lane's), which
        the train step sums. A leaf the placement split over the ``model``
        axis on another dim than its block's (a stacked [L, d] norm of
        ``MIN_SHARD_ELEMS`` or more, which the controller lane applies whole;
        a head [d, V] split on d where d >= V) is gathered, as GSPMD
        reshards it: onto the controller lane for a whole leaf
        (``lane_gather``), onto every lane, each then taking its block,
        otherwise (``lane_all_gather``); their backward hands each lane its
        block's grad. Another placement that does not hold the block
        raises."""
        got = self._lane_views_of
        if not train and got[0] is params:
            return got[1], got[2]
        lanes = self._lanes

        def blocks(path, leaf):
            if not isinstance(leaf, ShardedTensor):
                raise TypeError("a merged LM reads params placed over its lanes "
                                "(ShardedBackend.put_params, serve_param_shardings)")
            want = _lane_spec(path)
            split = [d for d, e in enumerate(leaf.sharding.spec) if e is not None]
            if train and len(split) == 1 and tuple(leaf.sharding.spec) != tuple(
                    want) + (None,) * (len(leaf.sharding.spec) - len(want)):
                if want == P():
                    return [collectives.lane_gather(leaf.shards, lanes, split[0])] * len(lanes)
                whole = collectives.lane_all_gather(leaf.shards, lanes, split[0])
                blocks = NamedSharding(self.mesh_info.mesh, want).blocks(leaf.shape)
                return [w[tuple(slice(a, b) for a, b in blk)] for w, blk in zip(whole, blocks)]
            out = []
            for lane, t in zip(lanes, lane_blocks(leaf, _lane_spec(path), strict=train)):
                if not train and not t.is_contiguous():
                    with lane.use():
                        t = t.contiguous()
                out.append(t)
            return out

        per = tree_map_with_path(blocks, params)
        tops = [_pick(per, j) for j in range(len(lanes))]
        layers = [[_index(top["blocks"], i) for i in range(self.cfg.n_layers)] for top in tops]
        if not train:
            self._lane_views_of = (params, tops, layers)
        return tops, layers

    @contextlib.contextmanager
    def _scope(self):
        """A merged call's work, queued on the controller lane's stream after
        the caller's (where the inputs were made; nothing to wait for under
        ``ShardedBackend.scope``, whose stream it is), the caller's stream
        waiting for it on the way out; the controller lane is the current
        lane."""
        root = self._lanes[0]
        with stream_scope(root.stream, root.device), root.use():
            yield

    def _bcast(self, t: Optional[torch.Tensor]) -> list:
        """A controller-lane tensor on every lane (``lane_broadcast``)."""
        if t is None:
            return [None] * len(self._lanes)
        return collectives.lane_broadcast(t, self._lanes)

    def _norm(self, x: torch.Tensor, w: torch.Tensor) -> list:
        """RMSNorm of the residual (on the controller lane), handed to every
        lane."""
        return self._bcast(rms_norm(x, w, self.cfg.norm_eps))

    def _merged_layers(self, layers, x, attend) -> torch.Tensor:
        """Every layer over the lanes (:meth:`_merged_layer`)."""
        for li in range(self.cfg.n_layers):
            x = self._merged_layer(layers, li, x, attend)
        return x

    def _merged_layer(self, layers, li: int, x: torch.Tensor, attend) -> torch.Tensor:
        """Layer ``li`` over the lanes: ``attend(li, hs)`` the summed
        attention output for the lanes' inputs ``hs``, then the MLP. Runs on
        the controller lane's stream, where the residual stays (also when
        backward recomputes it)."""
        with self._lanes[0].use():
            x = x + attend(li, self._norm(x, layers[0][li]["norm1"]))
            hs = self._norm(x, layers[0][li]["norm2"])
            return x + mlp_apply_lanes([lay[li]["mlp"] for lay in layers], hs, self._lanes)

    def _merged_forward(self, params, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """``forward`` over the lanes: each lane's heads through
        ``attention_apply`` at its share of the heads (``_lcfg``), its MLP
        partial sums and its vocabulary rows' logits, gathered on the first
        lane; ``remat == 'block'`` recomputes a layer across the lanes, on
        the same streams."""
        tops, layers = self._lane_params(params, train=True)
        lanes = self._lanes
        n = len(lanes)

        def apply(*args):  # attention_lanes sums the first entry of a lane's result
            return (attn_mod.attention_apply(*args),)

        def attend(li, hs):
            return attn_mod.attention_lanes(
                apply, lanes,
                [(layers[j][li]["attn"], self._lcfg, hs[j], pos[j]) for j in range(n)],
                [{}] * n)[0]

        with self._scope():
            x = self._merged_input(tops, batch)
            pos = self._bcast(torch.arange(x.shape[1], dtype=torch.int32, device=self.device))
            for li in range(self.cfg.n_layers):
                x = self._remat(self._merged_layer, layers, li, x, attend)
            logits = self._merged_logits(tops, x)
            return logits, torch.zeros((), dtype=torch.float32, device=self.device)

    def _merged_logits(self, tops, x: torch.Tensor) -> torch.Tensor:
        hs = self._norm(x, tops[0]["final_norm"])
        return unembed_lanes([top["embed"] for top in tops], hs, self._lanes)

    def _merged_input(self, tops, batch: dict) -> torch.Tensor:
        """x on the controller lane: ``batch["embeds"]`` in the model dtype,
        else the tokens' rows of each lane's vocabulary block, summed."""
        if "embeds" in batch:
            with self._lanes[0].use():
                return batch["embeds"].to(device=self.device, dtype=self.dtype)
        return embed_tokens_lanes([top["embed"]["tok"] for top in tops],
                                  self._bcast(batch["tokens"]), self._lanes)

    def _merged_prefill(self, params, batch, max_len, cache, slot):
        """``prefill`` over the lanes: each lane's flash attention over its
        heads writes its K/V rows into its cache shard."""
        tops, layers = self._lane_params(params)
        lead = next(iter(batch.values())).shape
        b, s = lead[0], lead[1]
        if s > max_len:
            raise ValueError(f"sequence {s} longer than max_len {max_len}")
        if cache is None:
            cache = self.init_cache(b, max_len)
        ks, vs = cache["k"].shards, cache["v"].shards
        n = len(self._lanes)

        def attend(li, hs):
            a, outs = attn_mod.attention_lanes(
                attn_mod.attention_apply, self._lanes,
                [(layers[j][li]["attn"], self._lcfg, hs[j], pos[j]) for j in range(n)],
                [dict(return_kv=True)] * n)
            for j, lane in enumerate(self._lanes):
                with lane.use():
                    k, v = outs[j][1]
                    ks[j][li, slot:slot + b, :s] = k
                    vs[j][li, slot:slot + b, :s] = v
            return a

        with self._scope():
            pos = self._bcast(torch.arange(s, dtype=torch.int32, device=self.device))
            x = self._merged_layers(layers, self._merged_input(tops, batch), attend)
            return self._merged_logits(tops, x), cache

    def _merged_step(self, params, cache, batch: dict, block_tables, fn, args: tuple,
                     out_rows: Optional[torch.Tensor] = None):
        """``decode_step`` (``fn`` = attention_decode, ``args`` = (cur_len,))
        or ``packed_step`` (attention_packed over (tok_slot, tok_pos, valid,
        pack_slots)) over the lanes: each lane's decode, ragged or paged
        kernel over its heads and its cache shard."""
        tops, layers = self._lane_params(params)
        ks, vs = cache["k"].shards, cache["v"].shards
        n = len(self._lanes)

        def attend(li, hs):
            return attn_mod.attention_lanes(
                fn, self._lanes,
                [(layers[j][li]["attn"], self._lcfg, hs[j], ks[j][li], vs[j][li],
                  *lane_args[j]) for j in range(n)],
                [dict(block_tables=tables[j]) for j in range(n)])[0]

        with self._scope():
            lane_args = list(zip(*[self._bcast(t) for t in args]))
            tables = self._bcast(block_tables)
            x = self._merged_layers(layers, self._merged_input(tops, batch), attend)
            if out_rows is not None:
                x = x[out_rows.long()]
            return self._merged_logits(tops, x), cache


def _in_lane(lane):
    """``lane.use()``, or nothing for no lane (one-lane calls)."""
    return contextlib.nullcontext() if lane is None else lane.use()


def _index(tree: Params, i: int) -> Params:
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _depth(tree: Params) -> int:
    """The stacked L of a block stack (its norm1, or a Mamba stack's norm,
    leaf's leading axis)."""
    return tree["norm1" if "norm1" in tree else "norm"].shape[0]


def pad_seq_axis(t: torch.Tensor, axis: int, max_len: int) -> torch.Tensor:
    """Pad axis ``axis`` (the cache sequence axis) up to ``max_len`` with
    zeros."""
    cur = t.shape[axis]
    if cur == max_len:
        return t
    return F.pad(t, [0, 0] * (t.ndim - 1 - axis) + [0, max_len - cur])


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """Model inputs for one (arch x shape) cell as empty ``meta`` tensors
    (the dry run's stand-ins; nothing is allocated), JAX's shapes and dtypes:

    * train:   {'tokens': (B, S), 'labels': (B, S)}  (int32)
    * prefill: {'tokens': (B, S)}
    * decode:  {'tokens': (B, 1)}  (the cache and cur_len are the caller's)

    Audio archs take precomputed frame embeddings (B, S, d_model) in
    ``cfg.dtype`` in place of 'tokens'; labels stay int32 codes."""
    b, s = shape.global_batch, shape.seq_len

    def tok_or_embed(n: int) -> dict:
        if cfg.modality == "audio":
            return {"embeds": torch.empty((b, n, cfg.d_model), dtype=getattr(torch, cfg.dtype),
                                          device="meta")}
        return {"tokens": torch.empty((b, n), dtype=torch.int32, device="meta")}

    if shape.kind == "train":
        return dict(tok_or_embed(s), labels=torch.empty((b, s), dtype=torch.int32,
                                                        device="meta"))
    if shape.kind == "prefill":
        return tok_or_embed(s)
    if shape.kind == "decode":
        return tok_or_embed(1)
    raise ValueError(shape.kind)
