"""Batched serving engine with continuous batching and the unified ragged
prefill+decode dispatch (counterpart of ``repro/serve/engine.py`` with
``unified=True``).

A fixed pool of ``batch_slots`` cache slots; requests are admitted into free
slots and every scheduling iteration advances work through three routes:

* **fused admission** — a prompt of at most ``prefill_budget`` tokens is
  padded to a power-of-two bucket and prefilled in one dispatch that also
  writes the slot's cache rows and samples the first token on the device
  (``LM.prefill`` → the GQA flash kernel);
* **ragged pack** — longer prompts are fed in chunks of at most
  ``prefill_budget`` tokens from up to ``_PACK_WIDTH`` admitting slots, one
  flat token batch padded to a T bucket (``LM.packed_step`` → the ragged
  kernel); a slot whose prompt completes samples its first token there;
* **decode chunk** — every decoding slot advances ``k ∈ {1, 2, 4, 8}``
  (≤ ``max_chunk``) steps in one dispatch, where ``k`` is the largest
  power of two in which no slot can finish (``LM.decode_step`` → the decode
  kernel). Inactive slots (empty or mid-prefill) ride along without
  advancing their length or changing their last token.

Every request carries its :class:`SamplingParams`; the per-slot parameter
rows live on the device and each dispatch runs the widest sampler variant
(``smode``) its slots need (``serve/sampling.py``). Every draw is keyed
``fold_in(key(seed), position)``, so a seeded stream does not change with
``max_chunk``, speculation or its neighbours; a request with ``seed=None``
takes one from the engine's ``seed`` at admission, in the JAX engine's
order.

With ``speculate`` ("ngram", "draft", "draft:<arch>", a
:class:`SpeculateConfig` or a drafter), decoding slots advance by
draft-and-verify instead of decode chunks: a drafter proposes up to ``k``
tokens a slot, ONE ``packed_step`` over the exact ``B·(K+1)`` verify rows
(the ragged kernel, or the paged kernel over block tables) scores them, and
the drafts that equal their seeded targets commit with the token after
them (``serve/speculate.py``).

Two opt-in cache layouts change where K/V live, not what is computed:

* **block-paged KV** (``kv_block_size``): one pool of ``num_blocks`` blocks
  of ``kv_block_size`` positions replaces the per-slot worst-case rows; each
  request reserves ``blocks_for(prompt, max_new)`` blocks at admission and
  reads them through its row of a ``[B, max_len / kv_block_size]`` block
  table. With ``prefix_cache`` a radix tree shares the full blocks of
  repeated prompt prefixes (block-aligned copy-on-write: a shared block is
  never written). A request the pool cannot hold waits at the head of the
  queue; one it could never hold is refused at submit.
* **quantized KV** (``kv_dtype`` in ``"f32"``, ``"int8"``, ``"fp8"``): K/V
  rows are stored quantized with per-(position, head) f32 scales, dense or
  paged. ``"f32"`` is the identity lane (bit-identical to the plain cache).

``weight_dtype="int8"`` quantizes the stacked matmul weights once at
construction (``models.quant.quantize_params``); every projection and MLP
product then runs the int8-weight matmul kernel. It combines with every
cache layout above.

An MLA model (``cfg.mla``: minicpm3-4b, deepseek-v2-lite-16b) serves on the
same three routes over its latent cache; it takes neither cache layout above
(``ValueError``, as the JAX package refuses a family without positional K/V)
nor int8 weights (``NotImplementedError``).

A mixture-of-experts model (``cfg.family == "moe"``: deepseek-v2-lite-16b
with MLA, llama4-scout-17b-a16e with GQA) serves on every route and option
its attention allows. Its experts' capacity depends on how many tokens one
call routes (``models.moe.moe_dispatch``), so each dispatch routes exactly
what the JAX engine's routes: a fused admission's whole power-of-two bucket,
every slot of a decode step (live or not), a pack's whole T bucket, and a
verify pack's exact ``B·(K+1)`` rows; padding always follows the live tokens.

Paged and quantized admissions always take the pack tier: the packed
scatter is the one write path that quantizes rows and routes through the
block tables.

Tick state (last tokens, per-slot lengths) lives on the device; the host
tracks counts only and reads dispatch t-1's token values after dispatch t is
enqueued, so the transfer overlaps device work (a verify tick reads its
values at once: what it commits depends on them). Host arrays reach the
card through pinned memory without a stream synchronisation. The KV cache
is updated in place (the JAX engine donates it).

Placement goes through a backend (``serve/backend.py``): ``device=d`` is the
shorthand for ``DeviceBackend(d)``, which on a CUDA device queues every
dispatch and host copy of the engine on a stream of its own. The cluster
hooks (``serve/cluster.py``): a thread-safe ``cancel``, ``reset``, and
``run(deadline_s=, on_tick=, gate=)``. Not ported: the legacy
prefill+insert tier and the tensor-parallel placement. The JAX engine's
compile counters (``prefill_compiles``) have no meaning in an eager engine.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.models.model import LM
from repro_torch.models.quant import quantize_params
from repro_torch.serve.backend import PlacementBackend, resolve_backend
from repro_torch.serve.kv_pool import BlockPool, blocks_for
from repro_torch.serve.prefix_cache import RadixPrefixCache
from repro_torch.serve.sampling import (
    SMODE_GREEDY,
    SamplingParams,
    fused_sample,
    param_rows,
    spec_verify,
)
from repro_torch.serve.speculate import SpeculateConfig, build_drafter


class AdmissionRejected(ValueError):
    """Typed submit-time rejection: the request was never queued.

    ``reason`` is one of the four admission outcomes:

    * ``"infeasible"`` — could never be served (it needs more KV blocks than
      the paged pool holds, or no live replica serves its model);
    * ``"shed_deadline"`` — its predicted TTFT exceeds its ``deadline_s``;
    * ``"rate_limited"`` — its tenant's token bucket is empty;
    * ``"queue_full"`` — bounded-queue backpressure.

    The last three come from the cluster's admission control
    (``serve/controller.py``). A :class:`ValueError`, so callers that caught
    the bare infeasible refusal keep working."""

    REASONS = ("infeasible", "shed_deadline", "rate_limited", "queue_full")

    def __init__(self, reason: str, detail: str = "") -> None:
        if reason not in self.REASONS:
            raise ValueError(f"unknown admission reason {reason!r}")
        self.reason = reason
        super().__init__(f"{reason}: {detail}" if detail else reason)


@dataclass(eq=False)
class Request:
    """One serving request (identity-based equality: a live lifecycle object).

    ``params=None`` means the caller configured no sampling: the request
    serves ``SamplingParams()`` unless a cluster's per-tenant default fills
    it first (:meth:`apply_default_params`)."""

    rid: int
    prompt: np.ndarray  # [S] int32
    params: Optional[SamplingParams] = None
    tenant: Optional[str] = None  # router affinity and speculation opt-out key
    model: Optional[str] = None  # heterogeneous cluster: pin to a named model
    deadline_s: Optional[float] = None  # TTFT budget: shed if predicted to miss
    generated: list[int] = field(default_factory=list)
    n_generated: int = 0  # tokens sampled so far (values may still be in flight)
    submitted_at: float = 0.0
    first_token_at: Optional[float] = None
    done_at: Optional[float] = None
    finish_reason: Optional[str] = None  # "length"|"stop"|"cancelled"|"rejected"
    reject_reason: Optional[str] = None  # AdmissionRejected.reason when rejected

    def __post_init__(self):
        self._explicit_params = self.params is not None
        if self.params is None:
            self.params = SamplingParams()

    def apply_default_params(self, params: SamplingParams) -> None:
        """Fill in a default ``SamplingParams`` (a cluster's per-tenant
        default); a no-op when the caller configured the request."""
        if self._explicit_params:
            return
        self.params = params
        self._explicit_params = True

    @property
    def complete(self) -> bool:
        """Finished AND every token value harvested to the host."""
        return self.finish_reason is not None and len(self.generated) >= self.n_generated


class RequestHandle:
    """Streaming view of one submitted request: an incremental token
    iterator plus ``cancel()``. Iterating drives the owning engine when no
    run loop does, and polls when a controller thread (a cluster's split
    replica) owns it."""

    def __init__(self, request: Request, owner) -> None:
        self.request = request
        self._owner = owner  # ServeEngine or ServeCluster
        self.replica = None  # split-mode routing target (set by ServeCluster)

    @property
    def rid(self) -> int:
        return self.request.rid

    @property
    def params(self) -> SamplingParams:
        return self.request.params

    @property
    def done(self) -> bool:
        return self.request.complete

    @property
    def finish_reason(self) -> Optional[str]:
        return self.request.finish_reason

    def cancel(self) -> None:
        self._owner.cancel(self.request)

    def tokens(self) -> Iterator[int]:
        """Yield generated token ids until the request finishes or is cancelled."""
        i = 0
        while True:
            if i < len(self.request.generated):
                yield self.request.generated[i]
                i += 1
            elif self.done:
                # the owner's bookkeeping hook (a cluster prunes its
                # request -> engine map here)
                done_hook = getattr(self._owner, "_handle_done", None)
                if done_hook is not None:
                    done_hook(self.request)
                return
            else:
                self._owner._handle_pump(self.request)

    __iter__ = tokens

    def result(self) -> list[int]:
        for _ in self.tokens():
            pass
        return self.request.generated


def percentile(xs: list[float], q: float) -> float:
    """Latency percentile with the empty-sample sentinel (0.0)."""
    return float(np.percentile(np.asarray(xs), q)) if xs else 0.0


@dataclass
class ServeStats:
    total_tokens: int = 0
    total_requests: int = 0
    cancelled: int = 0
    wall_seconds: float = 0.0
    ticks: int = 0
    queue_peak: int = 0
    alloc_failures: int = 0  # paged admissions that had to wait on the pool
    # peak resident KV bytes, dtype-aware: dense = the whole cache, paged =
    # peak used blocks x the measured bytes of one block
    kv_bytes_resident: int = 0
    peak_residents: int = 0  # most requests holding a slot at once
    # speculation: drafts dispatched to verify, drafts that matched their
    # seeded target (the token sampled after the run is neither), verify ticks
    spec_proposed: int = 0
    spec_accepted: int = 0
    spec_ticks: int = 0
    # admission counters: nonzero only at the cluster layer, which owns
    # admission control (ClusterStats carries them per run)
    shed: int = 0  # deadline-based load shedding (shed_deadline)
    rejected: int = 0  # rate_limited + queue_full rejections
    # per-request samples of the requests finished in this run: TTFT = first
    # token on the host - submitted; TPOT = mean inter-token time
    ttfts: list[float] = field(default_factory=list)
    tpots: list[float] = field(default_factory=list)

    @property
    def tokens_per_sec(self) -> float:
        return self.total_tokens / max(self.wall_seconds, 1e-9)

    @property
    def spec_acceptance(self) -> float:
        """Fraction of dispatched draft tokens that matched their target."""
        return self.spec_accepted / max(self.spec_proposed, 1)

    @property
    def ttft_p50(self) -> float:
        return percentile(self.ttfts, 50)

    @property
    def ttft_p99(self) -> float:
        return percentile(self.ttfts, 99)

    @property
    def tpot_p50(self) -> float:
        return percentile(self.tpots, 50)

    @property
    def tpot_p99(self) -> float:
        return percentile(self.tpots, 99)


def _norm_kv_dtype(kv_dtype) -> Optional[torch.dtype]:
    """``None`` is the plain (scale-less) cache; ``"f32"``/``"float32"`` the
    scaled machinery over an f32 store (the identity lane); ``"fp8"`` and
    its aliases store float8_e4m3fn rows; ``"int8"``/``"i8"`` int8 rows.
    torch dtypes of those three are accepted too; anything else raises."""
    if kv_dtype is None:
        return None
    names = {
        "f32": torch.float32, "float32": torch.float32,
        "int8": torch.int8, "i8": torch.int8,
        **{n: torch.float8_e4m3fn for n in (
            "f8", "fp8", "float8", "float8_e4m3", "float8_e4m3fn")},
    }
    dt = names.get(kv_dtype) if isinstance(kv_dtype, str) else kv_dtype
    if dt not in (torch.float32, torch.int8, torch.float8_e4m3fn):
        raise ValueError(f"unsupported kv_dtype: {kv_dtype!r}")
    return dt


def _bucket_len(s: int, max_len: int) -> int:
    """Next power of two >= s, capped at max_len (fused-admission buckets)."""
    b = 1
    while b < s:
        b *= 2
    return min(b, max_len) if b > s else b


# packed-tick size buckets (a 1.5x ladder), and the max admitting slots per pack
_T_BUCKETS = (8, 16, 24, 32, 48, 64, 96, 128)
_PACK_WIDTH = 2


def _bucket_tokens(t: int) -> int:
    for b in _T_BUCKETS:
        if t <= b:
            return b
    b = _T_BUCKETS[-1]
    while b < t:
        b *= 2
    return b


class ServeEngine:
    def __init__(
        self,
        model: LM,
        params,
        *,
        batch_slots: int = 4,
        max_len: int = 256,
        seed: int = 0,
        prefill_budget: int = 64,
        max_chunk: int = 8,
        kv_block_size: Optional[int] = None,
        num_blocks: Optional[int] = None,
        prefix_cache: bool = False,
        speculate=None,
        kv_dtype=None,
        weight_dtype=None,
        backend: Optional[PlacementBackend] = None,
        device=None,
    ):
        # every host -> device crossing goes through the backend; device=d is
        # the shorthand for DeviceBackend(d) (None: the card), which on a
        # CUDA device queues the engine's work on a stream of its own
        self.backend = resolve_backend(backend, device)
        self.device = self.backend.device
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, engine on {self.device}")
        with self.backend.scope():
            self._setup(model, params, batch_slots, max_len, seed, prefill_budget, max_chunk,
                        kv_block_size, num_blocks, prefix_cache, speculate, kv_dtype,
                        weight_dtype)

    def _setup(self, model, params, batch_slots, max_len, seed, prefill_budget, max_chunk,
               kv_block_size, num_blocks, prefix_cache, speculate, kv_dtype, weight_dtype):
        if not model.has_positional_kv:  # MLA's latent cache: dense and unquantized only
            if kv_dtype is not None:
                raise ValueError(f"family {model.family_tag!r} has no positional KV to quantize")
            if kv_block_size:
                raise ValueError(f"family {model.family_tag!r} has no positional KV to page")
        if model.cfg.mla is not None and weight_dtype not in (None, "f32", "float32",
                                                              torch.float32):
            raise NotImplementedError("int8 weights are not ported for MLA models")
        self.model = model
        # None keeps the params as given; "int8" rewrites the eligible stacked
        # weights to {"q8", "scale"} leaves (unquantized leaves shared)
        self.weight_dtype = weight_dtype
        self.params = self.backend.put_params(model, quantize_params(params, weight_dtype))
        self.B = batch_slots
        self.max_len = max_len
        self.prefill_budget = max(int(prefill_budget), 1)
        self.max_chunk = max(int(max_chunk), 1)
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        # speculation: a drafter proposes up to spec_k tokens a decoding slot,
        # one packed verify dispatch scores them (a SpeculateConfig, its CLI
        # string, or a drafter: anything with .propose)
        self.spec: Optional[SpeculateConfig] = None
        self.drafter = None
        if speculate not in (None, False, "off"):
            if hasattr(speculate, "propose"):
                self.spec = SpeculateConfig(
                    mode="draft" if getattr(speculate, "name", "") == "draft" else "ngram")
                self.drafter = speculate
            else:
                self.spec = SpeculateConfig.coerce(speculate)
                self.drafter = build_drafter(self.spec, model, params)
            self.spec_k = min(int(self.spec.k), max(max_len // 2, 1))
            self.drafter.setup(self.device, batch_slots, max_len, model.cfg.vocab_size)
            # per-slot acceptance EWMA behind the adaptive depth (a fresh slot
            # tries the full depth)
            self._spec_ewma = np.ones(batch_slots)
        self.kv_dtype = _norm_kv_dtype(kv_dtype)
        # quantized and paged admissions ride the pack tier only: the packed
        # scatter is the one write path that quantizes rows and routes
        # through the block tables
        self.kv_block_size = int(kv_block_size) if kv_block_size else 0
        self.paged = bool(self.kv_block_size)
        self._chunk_only_admit = self.kv_dtype is not None or self.paged
        if self.paged:
            if max_len % self.kv_block_size:
                raise ValueError(f"max_len={max_len} must be a multiple of "
                                 f"kv_block_size={self.kv_block_size}")
            self._maxb = max_len // self.kv_block_size  # table width
            # default pool: byte parity with the dense cache
            self.num_blocks = int(num_blocks) if num_blocks else batch_slots * self._maxb
            self.pool = BlockPool(self.num_blocks, self.kv_block_size)
            self.prefix = RadixPrefixCache(self.pool, self.kv_block_size) if prefix_cache else None
            # num_blocks + 1 blocks: the last is the scratch block that takes
            # the writes of sentinel table entries (models.attention)
            self.cache = model.init_kv_pool(self.num_blocks, self.kv_block_size,
                                            kv_dtype=self.kv_dtype)
            # one block's bytes over every leaf and layer, measured from the
            # live pool (payloads + scales); the scratch block is not counted
            self.pool.bytes_per_block = sum(
                t.numel() // t.shape[1] * t.element_size() for t in self.cache.values()
            )
            # host block lists and the [B, max_blocks] table; unallocated
            # entries hold the sentinel num_blocks
            self._slot_blocks: list[list[int]] = [[] for _ in range(batch_slots)]
            self._btab_h = np.full((batch_slots, self._maxb), self.num_blocks, np.int32)
            self._btab = self._put(self._btab_h.copy())
            self._btab_dirty = False
        else:
            if prefix_cache:
                raise ValueError("prefix_cache=True requires kv_block_size")
            self.pool = None
            self.prefix = None
            self.cache = model.init_cache(batch_slots, max_len, kv_dtype=self.kv_dtype)
        self.slot_req: list[Optional[Request]] = [None] * batch_slots
        self.slot_len = np.zeros(batch_slots, np.int32)  # host mirror (counts)
        self.slot_fed = np.zeros(batch_slots, np.int32)  # prompt tokens fed
        self.waiting: deque[Request] = deque()
        self.finished: list[Request] = []
        self._prefilling: list[int] = []  # slots mid-prefill, admission order
        self._done_now: list[Request] = []  # requests finished in this run()
        self._pending: deque = deque()  # dispatched, not yet harvested
        self._cancels: list[Request] = []  # the cross-thread abort inbox
        self._cancel_lock = threading.Lock()
        # serializes what advances the state machine: run() iterations, step()
        # (handle-driven streaming) and inline cancels
        self._drive_lock = threading.RLock()
        self._running = False  # a run() loop (possibly another thread) drives
        # poison pill: a cluster that declared this engine dead sets it, and a
        # stuck controller thread that resumes aborts its run() at the next
        # iteration boundary without touching the state already re-homed
        self._poisoned = False
        self._stream_stats = ServeStats()  # step()-driven serving
        # device-resident tick state and the per-slot "decoding" lane
        dev = self.device
        self._slot_ids = torch.arange(batch_slots, dtype=torch.int32, device=dev)
        self._last_tok = torch.zeros(batch_slots, dtype=torch.int32, device=dev)
        self._cur_len = torch.zeros(batch_slots, dtype=torch.int32, device=dev)
        self._active = torch.zeros(batch_slots, dtype=torch.int32, device=dev)
        self._dirty = False  # slot set changed: the active lane must re-upload
        # per-slot sampler rows on the device; the all-free rows stay cached
        # for every greedy dispatch, which reads none of them
        self._put_sp(*param_rows([None] * batch_slots, np.zeros(batch_slots)))
        self._sp0 = self._sp
        self._sp0_admit = self._put_rows(*param_rows([None], [0]))

    # ------------------------------------------------------------ transfers

    def _put(self, arr: np.ndarray) -> torch.Tensor:
        """Host array -> device, through the backend (on the card through
        pinned memory, queued without waiting for earlier work on the
        stream). The caller hands a fresh array it never mutates afterwards."""
        return self.backend.put_host(arr)

    def _put_rows(self, spf, spi, btok, bval) -> tuple:
        """Sampler rows (as ``param_rows`` builds them) -> device, in two
        uploads (the f32 rows, the int32 rows): ``(spf [2, B], spi [2, B],
        btok [B, K], bval [B, K])`` views."""
        b = btok.shape[0]
        f = self._put(np.concatenate([spf.ravel(), bval.ravel()]))
        i = self._put(np.concatenate([spi.ravel(), btok.ravel()]))
        return f[: 2 * b].view(2, b), i[: 2 * b].view(2, b), i[2 * b:].view(b, -1), \
            f[2 * b:].view(b, -1)

    def _put_sp(self, spf, spi, btok, bval) -> None:
        """Place the per-slot sampler rows on the device. They stay fresh until
        a new request takes a slot (a freed slot's stale row is harmless: an
        inactive slot's draw is discarded)."""
        self._sp = self._put_rows(spf, spi, btok, bval)
        self._sp_fresh = True

    def _sp_rows(self) -> tuple:
        """Host-built sampler rows of the current slot pool."""
        return param_rows(
            [r.params if r is not None else None for r in self.slot_req],
            [r._seed if r is not None else 0 for r in self.slot_req],
        )

    def _sp_admit(self, req: Request) -> tuple:
        """One admission's sampler rows (B = 1); a greedy request reuses the
        cached zero rows, which its dispatch never reads."""
        if req._smode == SMODE_GREEDY:
            return self._sp0_admit
        return self._put_rows(*param_rows([req.params], [req._seed]))

    def _bind(self, req: Request) -> None:
        """Resolve a request's sampling state once, at admission: its seed
        (drawn from the engine's rng when the caller left it None, in the JAX
        engine's admission order), its sampler variant, and whether it
        speculates (a tenant may opt out: its slot rides the verify dispatch
        at depth 0)."""
        if getattr(req, "_bound", False):
            return
        p = req.params
        req._seed = p.seed if p.seed is not None else int(self.rng.integers(1 << 31))
        req._smode = p.smode
        req._spec = self.spec is not None and self.spec.enabled_for(req.tenant)
        req._bound = True

    # ------------------------------------------------------------- dispatches

    @staticmethod
    def _sample(logits: torch.Tensor, sp, pos: torch.Tensor, smode: int) -> torch.Tensor:
        """``fused_sample`` of ``logits`` [R, V] under the sampler rows ``sp``
        (``_put_rows``' views, one row each) at PRNG positions ``pos`` [R]."""
        if smode == SMODE_GREEDY:
            return fused_sample(logits)
        spf, spi, btok, bval = sp
        return fused_sample(logits, spf[0], spi[0], spf[1], spi[1], pos, btok, bval,
                            smode=smode)

    def _tick_fn(self, last_tok, cur_len, active, n_steps: int, btab=None, sp=None,
                 smode: int = SMODE_GREEDY):
        """One decode chunk: ``n_steps`` decode + sample steps for every slot
        (through the block table ``btab`` when paged), each draw at PRNG
        position ``cur_len`` before its increment. Inactive
        slots keep their ``last_tok`` and length: their garbage K/V row at
        ``cur_len`` is rewritten before anything reads it, or, for a slot
        with no blocks, lands in the pool's scratch block. Returns (toks
        [n_steps, B], last_tok, cur_len)."""
        # an MoE model routes all B slots, inactive ones too (the JAX engine's
        # T). Above 16 slots C < B, so an inactive slot's garbage row can take
        # a live entry's capacity: where no key is valid the decode kernel
        # gives zeros and the plain version a uniform average, so the card and
        # the CPU may then route differently (ROADMAP Queue 3)
        act = active.bool()
        tok, cl = last_tok, cur_len
        toks = []
        for _ in range(n_steps):
            logits, _ = self.model.decode_step(
                self.params, self.cache, {"tokens": tok[:, None]}, cl, block_tables=btab
            )
            tok = torch.where(act, self._sample(logits[:, 0], sp, cl, smode), tok)
            cl = cl + active
            toks.append(tok)
        return torch.stack(toks), tok, cl

    def _packed_fn(self, last_tok, pack, tb: int, btab=None, sp=None,
                   smode: int = SMODE_GREEDY):
        """One ragged pack (through the block table ``btab`` when paged).
        ``pack`` is one int32 upload: the [3, tb] descriptor rows (token,
        local slot, position) then meta = new_len [B] | sample_idx [B] |
        sample_mask [B] | pack_slots [_PACK_WIDTH]. A slot whose prompt
        completes samples its first token from its final prompt row, at PRNG
        position ``new_len - 1``. Returns (sampled [B], last_tok, cur_len = new_len)."""
        # all tb rows go through the step (an MoE model routes the whole bucket,
        # as the JAX engine does); padding rows follow the live ones, so they
        # only take expert slots the live tokens left over
        b = self.B
        desc = pack[: 3 * tb].view(3, tb)
        meta = pack[3 * tb:]
        new_len = meta[:b]
        sample_idx = meta[b: 2 * b]
        sample_mask = meta[2 * b: 3 * b].bool()
        pack_slots = meta[3 * b:]
        logits, _ = self.model.packed_step(
            self.params, self.cache, desc[0], desc[1], desc[2],
            out_rows=sample_idx, pack_slots=pack_slots, block_tables=btab,
            max_len=self.max_len,
        )
        sampled = self._sample(logits, sp, new_len - 1, smode)
        return sampled, torch.where(sample_mask, sampled, last_tok), new_len

    def _admit_fn(self, toks, slot: int, last_pos: int, last_tok, cur_len, sp=None,
                  smode: int = SMODE_GREEDY):
        """One fused admission: prefill the bucket-padded prompt into the
        slot's cache rows, sample the first token from the last REAL prompt
        position (its PRNG position) under the admission's sampler rows
        ``sp``, and set the slot's tick state. Returns (tok, last_tok,
        cur_len)."""
        # the whole [1, sb] bucket is prefilled and, in an MoE model, routed:
        # capacity follows the bucket, and the bucket's padding comes last
        logits, _ = self.model.prefill(
            self.params, {"tokens": toks}, self.max_len, cache=self.cache, slot=slot
        )
        pos = torch.full((1,), last_pos, dtype=torch.int32, device=self.device)
        tok = self._sample(logits[0, last_pos][None], sp, pos, smode)[0]
        hit = self._slot_ids == slot
        return tok, torch.where(hit, tok, last_tok), torch.where(hit, last_pos + 1, cur_len)

    def _spec_fn(self, last_tok, cur_len, pack, depth_k: int, btab=None, sp=None,
                 smode: int = SMODE_GREEDY):
        """One draft-and-verify dispatch (through the block table ``btab``
        when paged): the packed step over the slot-major verify rows
        ``[last_token, draft_1 .. draft_K]`` of every slot (T = B·(K+1),
        exact), then the seeded exact-match acceptance (``spec_verify``).
        Row (i, j) scatters at (slot i, position cl + j) and attends keys up
        to it, so it sees the context and the drafts before it.

        ``pack`` is ONE [3, T + B] int32 upload: the first T columns the
        (token, global slot, position) rows, the last B the per-slot (depth,
        active, cl). Rows past a slot's depth carry the position sentinel
        ``max_len`` (scatter dropped, acceptance masked). Rejected rows need
        no rollback: their K/V lie past the committed length. Inactive slots
        pass through. Returns (targets [B, K+1], commit [B], last_tok,
        cur_len)."""
        b, w = self.B, depth_k + 1
        desc, meta = pack[:, : b * w], pack[:, b * w:]
        depth, act, cl = meta[0], meta[1], meta[2]
        active = act.bool()
        # exactly B·(K+1) rows, off the T buckets: an MoE model's capacity
        # follows this T, as in the JAX engine
        logits, _ = self.model.packed_step(
            self.params, self.cache, desc[0], desc[1], desc[2], block_tables=btab
        )
        drafts = desc[0].reshape(b, w)[:, 1:]
        temps = top_k = top_p = seeds = btok = bval = None  # smode 0 reads none
        if smode != SMODE_GREEDY:
            spf, spi, btok, bval = sp
            temps, top_k, top_p, seeds = spf[0], spi[0], spf[1], spi[1]
        targets, n_acc, commit = spec_verify(
            logits, drafts, depth, act, temps, top_k, top_p, seeds, cl, btok, bval, smode=smode,
        )
        ar = torch.arange(b, device=targets.device)
        last_tok = torch.where(active, targets[ar, n_acc.long()], last_tok)
        cur_len = torch.where(active, cl + commit, cur_len)
        return targets, commit, last_tok, cur_len

    # --------------------------------------------------------- token harvest

    def _credit(self, req: Request, tok: int, now: float,
                stats: Optional[ServeStats], first: bool = False) -> None:
        """Append one harvested token, detecting stop tokens; values past a
        stop or a cancel are discarded (and a decode value refunded)."""
        if req.finish_reason in ("stop", "cancelled") or len(req.generated) >= req.n_generated:
            if stats is not None and not first:
                stats.total_tokens -= 1
            return
        req.generated.append(tok)
        if first and req.first_token_at is None:
            req.first_token_at = now
        if tok in req.params.stop:
            req.finish_reason = "stop"
            req.n_generated = len(req.generated)
            req.done_at = now

    @staticmethod
    def _stamp(req: Request, now: float) -> None:
        # done_at was stamped at enqueue; pull it forward to when the values
        # reached the host
        if req.done_at is not None:
            req.done_at = max(req.done_at, now)

    def _harvest(self, entry) -> None:
        """Pull one dispatch's sampled tokens to the host (this waits for it)
        and credit the slots' requests."""
        kind, tok_dev, items, stats = entry
        toks = tok_dev.cpu().numpy()
        now = time.perf_counter()
        if kind == "admit":
            slot, req = items
            self._credit(req, int(toks), now, stats, first=True)
            self._stamp(req, now)
        elif kind == "packed":
            for slot, req in items:
                self._credit(req, int(toks[slot]), now, stats, first=True)
                self._stamp(req, now)
        else:  # decode chunk: [n_steps, B]
            for slot, req in items:
                if not req.params.stop and len(req.generated) + len(toks) <= req.n_generated:
                    req.generated.extend(int(t) for t in toks[:, slot])
                else:
                    for t in toks[:, slot]:
                        self._credit(req, int(t), now, stats)
                self._stamp(req, now)

    def _drain_pending(self) -> None:
        while self._pending:
            self._harvest(self._pending.popleft())

    def _flush_btab(self) -> Optional[torch.Tensor]:
        """The device block table (None when not paged), re-uploaded only
        after a slot's mapping changed. The upload gets a fresh copy: a
        release rewrites the host rows while a dispatch that reads the
        previous table may still be in flight, and the pinned copy is taken
        without waiting for it."""
        if not self.paged:
            return None
        if self._btab_dirty:
            self._btab = self._put(self._btab_h.copy())
            self._btab_dirty = False
        return self._btab

    def _release_slot_blocks(self, slot: int) -> None:
        """Drop the slot's references on its blocks (finish/cancel). Blocks
        the prefix tree retains stay resident; the rest go back to the free
        list, and a new owner's writes are enqueued after every dispatch
        that still reads them."""
        self.pool.release_all(self._slot_blocks[slot])
        self._slot_blocks[slot] = []
        self._btab_h[slot, :] = self.num_blocks
        self._btab_dirty = True

    def _flush_events(self) -> torch.Tensor:
        """The [B] int32 "decoding" lane, re-uploaded only after a slot change.
        A mid-prefill slot is inactive until its last pack completes."""
        if self._dirty:
            act = np.array(
                [r is not None and self.slot_fed[i] >= len(r.prompt)
                 for i, r in enumerate(self.slot_req)], np.int32,
            )
            self._active = self._put(act)
            self._dirty = False
        return self._active

    # ------------------------------------------------------------------ API

    def prewarm(self, sampling: bool = False) -> None:
        """Build the kernels and run one dummy dispatch per route (decode
        chunk, ragged pack and, where admissions take it, fused admission)
        off the clock; ``sampling=True`` runs each at every sampler variant
        (smodes 0, 1, 2), and a speculating engine also runs its drafter's
        prewarm and a verify dispatch at every depth of the ladder {1, 2, 4,
        .., spec_k}. Results are discarded and the tick state is untouched;
        call on an IDLE engine: the dummies write garbage into cache rows
        nothing reads yet (a paged engine's all-sentinel tables send them to
        the scratch block)."""
        with self._drive_lock, self.backend.scope():
            self._prewarm(sampling)

    def _prewarm(self, sampling: bool) -> None:
        smodes = (0, 1, 2) if sampling else (0,)
        idle = torch.zeros(self.B, dtype=torch.int32, device=self.device)
        btab = self._flush_btab()
        tb = _T_BUCKETS[0]
        desc = np.zeros((3, tb), np.int32)
        desc[2, 1:] = self.max_len  # token 0 at row 0 of slot 0, then padding
        meta = np.concatenate([self.slot_len, np.zeros(2 * self.B + _PACK_WIDTH, np.int32)])
        for sm in smodes:
            self._tick_fn(self._last_tok, self._cur_len, idle, 1, btab, self._sp0, sm)
            self._packed_fn(self._last_tok, self._put(np.concatenate([desc.ravel(), meta])), tb,
                            btab, self._sp0, sm)
            if not self._chunk_only_admit:
                self._admit_fn(self._put(np.zeros((1, 1), np.int32)), 0, 0, self._last_tok,
                               self._cur_len, self._sp0_admit, sm)
        if self.spec is not None:
            self.drafter.prewarm()
            kk = 1
            while True:  # every slot inactive: nothing commits
                pack = np.zeros((3, self.B * (kk + 1) + self.B), np.int32)
                pack[2, 1: self.B * (kk + 1)] = self.max_len  # row 0 at slot 0, position 0
                for sm in smodes:
                    self._spec_fn(self._last_tok, self._cur_len, self._put(pack), kk, btab,
                                  self._sp0, sm)
                if kk >= self.spec_k:
                    break
                kk *= 2
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def submit(self, req: Request) -> RequestHandle:
        if len(req.prompt) >= self.max_len:
            raise ValueError(f"prompt of {len(req.prompt)} tokens needs max_len > that")
        if self.paged:
            need = blocks_for(len(req.prompt), req.params.max_new, self.max_len,
                              self.kv_block_size)
            if need > self.num_blocks:  # a wait could never resolve
                raise AdmissionRejected(
                    "infeasible", f"request needs {need} KV blocks, pool holds {self.num_blocks}"
                )
        req.submitted_at = time.perf_counter()
        self.waiting.append(req)
        return RequestHandle(req, self)

    def cancel(self, req: Request) -> None:
        """Abort a request (thread-safe): dequeue it if waiting, free its slot
        if admitted. In-flight token values are discarded; no other slot is
        perturbed. Applied now when no run loop owns the engine, else at the
        loop's next iteration boundary."""
        with self._cancel_lock:
            # the append AND the _running read under the lock: an unlocked
            # append could land on a list _apply_cancels already swapped out,
            # and run() flips _running under the same lock
            self._cancels.append(req)
            running = self._running
        if not running:
            with self._drive_lock:
                self._apply_cancels(self._stream_stats)

    def _apply_cancels(self, stats: ServeStats) -> None:
        if not self._cancels:
            return
        with self._cancel_lock:
            cancels, self._cancels = self._cancels, []
            for req in cancels:
                if req.finish_reason is not None:
                    continue
                if req in self.waiting:
                    self.waiting.remove(req)
                for slot, r in enumerate(self.slot_req):
                    if r is req:
                        self.slot_req[slot] = None
                        self.slot_len[slot] = 0
                        self.slot_fed[slot] = 0
                        if slot in self._prefilling:
                            self._prefilling.remove(slot)
                        if self.paged:  # a cancel frees the blocks mid-stream
                            self._release_slot_blocks(slot)
                        self._dirty = True
                req.finish_reason = "cancelled"
                req.n_generated = len(req.generated)
                req.done_at = time.perf_counter()
                self.finished.append(req)
                self._done_now.append(req)
                stats.cancelled += 1

    def _release_stopped(self, stats: ServeStats) -> None:
        for slot, r in enumerate(self.slot_req):
            if r is not None and r.finish_reason == "stop":
                self._finish(r, slot, stats)

    def _finish(self, req: Request, slot: int, stats: Optional[ServeStats],
                reason: str = "length") -> None:
        if req.finish_reason is None:
            req.finish_reason = reason
        if req.done_at is None:
            req.done_at = time.perf_counter()
        self.finished.append(req)
        self._done_now.append(req)
        self.slot_req[slot] = None
        self.slot_len[slot] = 0
        if self.paged:
            self._release_slot_blocks(slot)
        if stats is not None:
            stats.total_requests += 1
        self._dirty = True

    def _admit_unified(self, stats: ServeStats) -> None:
        """Bind waiting requests to free slots: short prompts take the fused
        admission now, longer ones (and every one of a quantized cache) join
        the chunked pack tier."""
        for slot in range(self.B):
            while self.slot_req[slot] is None and self.waiting:
                req = self.waiting.popleft()
                self._bind(req)
                s = len(req.prompt)
                self.slot_req[slot] = req
                self._sp_fresh = False  # a new occupant's row must upload
                self._dirty = True
                self._spec_admit(slot)
                if self._chunk_only_admit or s > self.prefill_budget:
                    self.slot_len[slot] = 0
                    self.slot_fed[slot] = 0
                    self._prefilling.append(slot)
                    continue
                sb = _bucket_len(s, self.max_len)
                toks = np.zeros((1, sb), np.int32)
                toks[0, :s] = req.prompt
                tok, self._last_tok, self._cur_len = self._admit_fn(
                    self._put(toks), slot, s - 1, self._last_tok, self._cur_len,
                    self._sp_admit(req), req._smode,
                )
                self.slot_len[slot] = s
                self.slot_fed[slot] = s
                req.n_generated += 1  # the first token, in flight
                self._pending.append(("admit", tok, (slot, req), stats))
                if req.n_generated >= req.params.max_new:
                    self._finish(req, slot, stats)

    def _admit_paged(self) -> None:
        """Paged admission: consult the prefix tree, reserve the request's
        whole worst-case block table, and bind the slot to the pack tier at
        the first unmatched position.

        * Matched blocks (block-aligned) enter the table read-only and
          ``slot_fed`` starts past them, so they are never written.
        * Allocation is all-or-nothing and up front (``blocks_for``): decode
          never runs out mid-stream. A request the pool cannot hold yet
          stays at the head of the queue (after LRU eviction of tree-only
          blocks) until a finishing request frees capacity.
        """
        for slot in range(self.B):
            while self.slot_req[slot] is None and self.waiting:
                req = self.waiting[0]
                self._bind(req)
                s = len(req.prompt)
                need_total = blocks_for(s, req.params.max_new, self.max_len, self.kv_block_size)
                shared: list[int] = []
                matched = 0
                if self.prefix is not None:
                    shared, matched = self.prefix.match(req.prompt)
                need = need_total - len(shared)
                if not self.pool.can_alloc(need):
                    if self.prefix is not None:
                        self.prefix.evict(need - self.pool.free)
                    if not self.pool.can_alloc(need):
                        # pool exhausted: give back the matched references and
                        # leave the request waiting, FCFS order intact
                        self.pool.alloc_failures += 1
                        self.pool.release_all(shared)
                        return
                self.waiting.popleft()
                blocks = shared + self.pool.alloc(need)
                self._slot_blocks[slot] = blocks
                row = self._btab_h[slot]
                row[:] = self.num_blocks
                row[: len(blocks)] = blocks
                self._btab_dirty = True
                self.slot_req[slot] = req
                self._sp_fresh = False  # a new occupant's row must upload
                self._dirty = True
                self._spec_admit(slot)
                self.slot_len[slot] = matched
                self.slot_fed[slot] = matched
                self._prefilling.append(slot)

    def _spec_admit(self, slot: int) -> None:
        """A new occupant starts at the full depth, with a fresh draft cache."""
        if self.spec is not None:
            self._spec_ewma[slot] = 1.0
            self.drafter.reset_slot(slot)

    def _slot_sampler(self, slots) -> tuple[int, tuple]:
        """The widest sampler variant of ``slots`` and the rows its dispatch
        reads: the resident rows (uploaded first if stale) when any samples,
        the cached zero rows when all are greedy."""
        smode = max((self.slot_req[i]._smode for i in slots), default=SMODE_GREEDY)
        if not smode:
            return smode, self._sp0
        if not self._sp_fresh:
            self._put_sp(*self._sp_rows())
        return smode, self._sp

    def _packed_tick(self, stats: ServeStats) -> None:
        """Build and dispatch one ragged pack: up to ``prefill_budget`` prompt
        tokens, FCFS across at most ``_PACK_WIDTH`` admitting slots, padded
        to a T bucket (padding: local slot 0, position max_len)."""
        entries: list[tuple[int, int, int]] = []  # (token, LOCAL slot, pos)
        sample_idx = np.zeros(self.B, np.int32)
        sample_mask = np.zeros(self.B, bool)
        pack_slots = np.zeros(_PACK_WIDTH, np.int32)
        budget = self.prefill_budget
        completed: list[int] = []
        for local, i in enumerate(self._prefilling[:_PACK_WIDTH]):
            if budget <= 0:
                break
            pack_slots[local] = i
            req = self.slot_req[i]
            fed = int(self.slot_fed[i])
            n = min(budget, len(req.prompt) - fed)
            budget -= n
            for j in range(n):
                entries.append((int(req.prompt[fed + j]), local, fed + j))
            self.slot_fed[i] = fed + n
            self.slot_len[i] = fed + n
            if fed + n == len(req.prompt):
                sample_idx[i] = len(entries) - 1  # the final prompt token
                sample_mask[i] = True
                completed.append(i)
                self._prefilling.remove(i)
                self._dirty = True  # becomes an active decoder
        tb = _bucket_tokens(len(entries))
        desc = np.zeros((3, tb), np.int32)
        desc[2] = self.max_len
        for t, (tok, sl, pos) in enumerate(entries):
            desc[:, t] = (tok, sl, pos)
        meta = np.concatenate([self.slot_len, sample_idx, sample_mask.astype(np.int32), pack_slots])
        # only the slots this pack samples pick its variant
        smode, sp = self._slot_sampler(completed)
        toks, self._last_tok, self._cur_len = self._packed_fn(
            self._last_tok, self._put(np.concatenate([desc.ravel(), meta])), tb,
            self._flush_btab(), sp, smode,
        )
        stats.ticks += 1
        if completed:
            if self.prefix is not None:
                # the prompts' K/V now sit in their blocks (the dispatch above
                # is ordered before any later reader): register their full
                # blocks BEFORE an instant finish below releases the slot —
                # the tree takes its own references
                for i in completed:
                    self.prefix.insert(self.slot_req[i].prompt, self._slot_blocks[i])
            items = []
            for i in completed:
                req = self.slot_req[i]
                req.n_generated += 1  # first token (not counted in total_tokens)
                items.append((i, req))
            self._pending.append(("packed", toks, items, stats))
            for i in completed:
                req = self.slot_req[i]
                if req.n_generated >= req.params.max_new:
                    self._finish(req, i, stats)

    def _chunk_tick(self, stats: ServeStats, active: list[int]) -> None:
        """One decode chunk of k steps, k the largest power of two <=
        ``max_chunk`` in which no active slot can finish (so chunking never
        changes the output)."""
        rem = min(
            min(
                self.slot_req[i].params.max_new - self.slot_req[i].n_generated,
                self.max_len - 1 - int(self.slot_len[i]),
            )
            for i in active
        )
        cap = max(1, min(rem, self.max_chunk))
        k = 1
        while k * 2 <= cap:
            k *= 2
        lanes = self._flush_events()
        smode, sp = self._slot_sampler(active)
        toks, self._last_tok, self._cur_len = self._tick_fn(
            self._last_tok, self._cur_len, lanes, k, self._flush_btab(), sp, smode
        )
        stats.ticks += k
        self._pending.append(("chunk", toks, [(i, self.slot_req[i]) for i in active], stats))
        for i in active:
            req = self.slot_req[i]
            self.slot_len[i] += k
            req.n_generated += k
            stats.total_tokens += k
            if req.n_generated >= req.params.max_new or self.slot_len[i] + 1 >= self.max_len:
                self._finish(req, i, stats)

    def _spec_depth(self, slot: int) -> int:
        """Adaptive proposal depth of one slot from its acceptance EWMA, in
        the ladder {1, 2, 4, .., spec_k}; ``spec_k`` with adaptation off."""
        if not self.spec.adaptive:
            return self.spec_k
        e = self._spec_ewma[slot]
        for thresh, d in ((0.7, 8), (0.45, 4), (0.2, 2)):
            if e >= thresh:
                return min(d, self.spec_k)
        return 1

    def _spec_tick(self, stats: ServeStats) -> None:
        """One draft-and-verify iteration over every decoding slot: harvest
        everything in flight (the drafter reads committed values, and what a
        verify commits depends on them), draft, run ONE verify dispatch, read
        its targets and commits back at once, and credit the accepted runs.

        A slot's depth is capped at ``rem - 1`` (rem its remaining budget, as
        in ``_chunk_tick``), so a commit never passes ``max_new``/``max_len``
        and every verify row stays inside the slot's row or reserved table.
        A stop token is found in the credit path; values past it are
        refunded, so the stream stops where the sequential engine's does."""
        self._drain_pending()
        self._release_stopped(stats)
        decoding = [
            i for i, r in enumerate(self.slot_req)
            if r is not None and self.slot_fed[i] >= len(r.prompt)
        ]
        if not decoding:
            return
        b = self.B
        depths = np.zeros(b, np.int32)
        ctxs: list[Optional[np.ndarray]] = [None] * b
        for i in decoding:
            r = self.slot_req[i]
            rem = min(r.params.max_new - r.n_generated, self.max_len - 1 - int(self.slot_len[i]))
            d = min(self.spec_k, rem - 1, self._spec_depth(i)) if r._spec else 0
            depths[i] = max(d, 0)
            if depths[i] > 0:
                ctxs[i] = np.concatenate(
                    [np.asarray(r.prompt, np.int64), np.asarray(r.generated, np.int64)])
        if depths.any():
            props = self.drafter.propose(ctxs, depths)
            for i in decoding:
                depths[i] = min(int(depths[i]), len(props[i]))
        else:
            props = [[] for _ in range(b)]
        kmax = max(1, int(depths.max()))
        depth_k = 1
        while depth_k < kmax:
            depth_k *= 2
        w = depth_k + 1
        # slot-major verify rows [last_token, draft_1 .. draft_d]; rows past
        # a slot's depth (and whole inactive slots) carry the position
        # sentinel. pack[:, :b*w] the descriptors, pack[:, b*w:] (depth,
        # active, cl) per slot: one upload
        pack = np.zeros((3, b * w + b), np.int32)
        desc = pack[:, : b * w]
        meta = pack[:, b * w:]
        desc[2] = self.max_len
        for i in decoding:
            r = self.slot_req[i]
            d = int(depths[i])
            cl = int(self.slot_len[i])
            r0 = i * w
            desc[0, r0] = r.generated[-1]
            if d:
                desc[0, r0 + 1: r0 + 1 + d] = props[i][:d]
            desc[1, r0: r0 + 1 + d] = i
            desc[2, r0: r0 + 1 + d] = cl + np.arange(d + 1)
            meta[:, i] = (d, 1, cl)
        smode, sp = self._slot_sampler(decoding)
        targets, commit, self._last_tok, self._cur_len = self._spec_fn(
            self._last_tok, self._cur_len, self._put(pack), depth_k, self._flush_btab(), sp,
            smode,
        )
        stats.ticks += 1
        stats.spec_ticks += 1
        both = torch.cat([targets.reshape(-1), commit]).cpu().numpy()  # one transfer
        t_h, c_h = both[: b * w].reshape(b, w), both[b * w:]
        now = time.perf_counter()
        for i in decoding:
            r = self.slot_req[i]
            c = int(c_h[i])  # the accepted run and the token after it, >= 1
            d = int(depths[i])
            stats.spec_proposed += d
            stats.spec_accepted += c - 1
            if self.spec.adaptive and d > 0:
                self._spec_ewma[i] = 0.5 * self._spec_ewma[i] + 0.5 * ((c - 1) / d)
            r.n_generated += c
            self.slot_len[i] += c
            stats.total_tokens += c
            for j in range(c):
                self._credit(r, int(t_h[i, j]), now, stats)
            self._stamp(r, now)
            if r.finish_reason is None and (
                r.n_generated >= r.params.max_new or self.slot_len[i] + 1 >= self.max_len
            ):
                self._finish(r, i, stats)

    def _service_once(self, stats: ServeStats, admit: bool = True) -> bool:
        """ONE scheduling iteration: apply cancellations, release
        stop-finished slots, admit, dispatch a pack (if any admission is
        mid-prefill) and a decode chunk (a verify tick when speculating),
        then harvest everything older than the newest dispatch. Returns
        whether any work remains. ``admit=False`` drains the slots without
        taking from the queue (a control interval's end)."""
        self._apply_cancels(stats)
        self._release_stopped(stats)
        if not admit:
            pass
        elif self.paged:
            self._admit_paged()
        else:
            self._admit_unified(stats)
        stats.kv_bytes_resident = max(stats.kv_bytes_resident, self.kv_bytes_resident())
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        stats.peak_residents = max(stats.peak_residents, len(active))
        if not active:
            self._drain_pending()
            self._release_stopped(stats)
            return bool(self.waiting) or any(r is not None for r in self.slot_req)
        if self._prefilling:
            self._packed_tick(stats)
            if self.spec is not None:
                self._spec_tick(stats)
            else:
                decoding = [
                    i for i, r in enumerate(self.slot_req)
                    if r is not None and self.slot_fed[i] >= len(r.prompt)
                ]
                if decoding:
                    self._chunk_tick(stats, decoding)
        elif self.spec is not None:
            self._spec_tick(stats)
        else:
            self._chunk_tick(stats, active)
        while len(self._pending) > 1:
            self._harvest(self._pending.popleft())
        return True

    def kv_bytes_resident(self) -> int:
        """Bytes of KV state resident now, dtype-aware: the whole dense cache
        (every slot's worst case is resident), or the paged pool's used
        blocks times the measured bytes of one block."""
        if self.paged:
            return self.pool.used * self.pool.bytes_per_block
        return sum(t.numel() * t.element_size() for t in self.cache.values())

    @property
    def stream_stats(self) -> ServeStats:
        """Stats of step()-driven serving (handle iterators, inline cancels)."""
        return self._stream_stats

    def step(self) -> bool:
        """Advance by one scheduling iteration; returns whether work remains."""
        with self._drive_lock, self.backend.scope():
            busy = self._service_once(self._stream_stats)
            if not busy:
                self._drain_pending()
                self._release_stopped(self._stream_stats)
            return busy

    def _handle_pump(self, req: Request) -> None:
        """Progress for a blocked handle iterator: drive the engine when no
        run loop owns it, poll when a controller thread does. A poisoned
        (declared-dead) engine is never driven: the handle polls until the
        cluster has re-homed its request."""
        if self._running or self._poisoned:
            time.sleep(1e-4)
            return
        if self.step():
            return
        self._apply_cancels(self._stream_stats)
        if not req.complete:
            raise RuntimeError(
                f"engine idle but request {req.rid} incomplete — was it submitted here?"
            )

    def reset(self) -> None:
        """Return an IDLE engine to its just-constructed serving state: the
        device tick state, the sampler rows, the slot bookkeeping and the
        queues, the drafter's slots and the acceptance EWMA, and (paged) the
        pool, the prefix tree and the block table. The KV cache (garbage
        nothing reads) and the weights stay: a cluster's warm switch back to
        a built fabric costs no placement. Refuses a busy engine."""
        if any(r is not None for r in self.slot_req):
            raise RuntimeError("reset() on a busy engine")
        with self._drive_lock, self.backend.scope():
            self.slot_len[:] = 0
            self.slot_fed[:] = 0
            self.waiting.clear()
            self.finished = []
            self._prefilling.clear()
            self._done_now = []
            self._pending.clear()
            with self._cancel_lock:
                self._cancels.clear()
            self._stream_stats = ServeStats()
            self.rng = np.random.default_rng(self.seed)
            dev = self.device
            self._last_tok = torch.zeros(self.B, dtype=torch.int32, device=dev)
            self._cur_len = torch.zeros(self.B, dtype=torch.int32, device=dev)
            self._active = torch.zeros(self.B, dtype=torch.int32, device=dev)
            self._dirty = False
            self._put_sp(*param_rows([None] * self.B, np.zeros(self.B)))
            if self.spec is not None:
                self._spec_ewma[:] = 1.0
                for i in range(self.B):
                    self.drafter.reset_slot(i)
            if self.paged:
                if self.prefix is not None:
                    self.prefix.clear()
                self.pool.reset()
                self._slot_blocks = [[] for _ in range(self.B)]
                self._btab_h[:] = self.num_blocks
                self._btab = self._put(self._btab_h.copy())
                self._btab_dirty = False

    def run(self, arrivals=None, *, deadline_s=None, on_tick=None, gate=None) -> ServeStats:
        """Drain all submitted requests; returns throughput + latency stats.

        ``arrivals`` optionally replays an open-loop stream of
        ``(t_offset_seconds, Request)``, each submitted once the run clock
        passes its offset (its TTFT clock starts at the scheduled time).

        ``gate`` is the admission hook of arrival-stream requests: called
        with each due request before it joins the queue, it may raise
        :class:`AdmissionRejected`; the request then finishes at once as
        ``"rejected"`` (an open-loop stream has no caller to raise into).

        ``deadline_s`` bounds the run to a control interval: past it the
        loop stops admitting and exits once the slots drain; waiting
        requests stay queued for the next run.

        ``on_tick`` is called once per scheduling iteration outside the drive
        lock (a cluster's watchdog heartbeat and fault-injection point);
        after each call a poisoned engine stops at the iteration boundary."""
        stats = ServeStats()
        self._done_now = []
        alloc_fail0 = self.pool.alloc_failures if self.paged else 0
        t0 = time.perf_counter()
        arr: deque = deque(sorted(arrivals, key=lambda a: a[0]) if arrivals else ())
        with self._cancel_lock:  # see cancel(): no inline apply may overlap
            self._running = True
        try:
            with self.backend.scope():
                while True:
                    if on_tick is not None:
                        on_tick()
                    if self._poisoned:
                        break
                    now = time.perf_counter() - t0
                    while arr and arr[0][0] <= now:
                        t_off, req = arr.popleft()
                        if gate is not None:
                            try:
                                gate(req)
                            except AdmissionRejected as rej:
                                req.finish_reason = "rejected"
                                req.reject_reason = rej.reason
                                req.submitted_at = t0 + t_off
                                req.done_at = time.perf_counter()
                                self.finished.append(req)
                                continue
                        self.submit(req)
                        req.submitted_at = t0 + t_off
                    stats.queue_peak = max(stats.queue_peak, len(self.waiting))
                    expired = deadline_s is not None and now >= deadline_s
                    if not (any(r is not None for r in self.slot_req)
                            or (self.waiting and not expired) or arr or self._cancels):
                        break
                    with self._drive_lock:  # serialized against inline cancels, step()
                        busy = self._service_once(stats, admit=not expired)
                    if not busy and arr:
                        wait = arr[0][0] - (time.perf_counter() - t0)
                        if wait > 0:
                            time.sleep(min(wait, 0.001))
                if not self._poisoned:
                    with self._drive_lock:
                        self._drain_pending()
                        self._release_stopped(stats)
        finally:
            with self._cancel_lock:
                self._running = False
        stats.wall_seconds = time.perf_counter() - t0
        stats.kv_bytes_resident = max(stats.kv_bytes_resident, self.kv_bytes_resident())
        if self.paged:
            stats.alloc_failures = self.pool.alloc_failures - alloc_fail0
        for req in self._done_now:
            if req.first_token_at is not None:
                stats.ttfts.append(req.first_token_at - req.submitted_at)
                if req.done_at is not None and req.n_generated >= 2:
                    stats.tpots.append(
                        max(req.done_at - req.first_token_at, 0.0) / (req.n_generated - 1)
                    )
        return stats
