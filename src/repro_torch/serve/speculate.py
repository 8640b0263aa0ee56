"""Speculative decoding: the drafters behind the engine's packed
draft-and-verify dispatch (counterpart of ``repro/serve/speculate.py``).

A drafter proposes up to ``k`` tokens for each decoding slot; the engine
feeds ``[last_token, draft_1 .. draft_d]`` of every slot through ONE
``packed_step`` (the ragged kernel over a dense cache, the paged kernel over
block tables), samples all ``d + 1`` target positions with the per-position
keys ``fold_in(key(seed), pos)``, and commits the longest prefix of drafts
that EXACTLY match their targets (:func:`repro_torch.serve.sampling
.spec_verify`). Every committed token is the one the sequential engine
samples, so a stream with speculation on equals the stream with it off
wherever the verify rows' logits equal sequential decode's (on the CPU
they do; on the card the pack and decode kernels may round a bf16 logit
apart, and a near-tie can then go the other way).

Rejected tails need no rollback: their K/V lie past the committed length,
which every attention read masks, and the next dispatch overwrites them.

Two drafters: :class:`NGramDrafter` (a host-side suffix match against the
request's own tokens) and :class:`ModelDrafter` (a shallow model with its own
KV cache over the engine's slot layout).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Mapping, Optional, Protocol, Sequence, runtime_checkable

import numpy as np
import torch

# the drafter's catch-up pack sizes (the JAX package's ladder)
_PACK_BUCKETS = (8, 16, 24, 32, 48, 64, 96, 128)


def _bucket(t: int) -> int:
    for b in _PACK_BUCKETS:
        if t <= b:
            return b
    b = _PACK_BUCKETS[-1]
    while b < t:
        b *= 2
    return b


@dataclass(frozen=True)
class SpeculateConfig:
    """Engine-level speculation configuration.

    ``mode`` selects the drafter ("ngram" or "draft"); ``k`` caps the
    proposal depth per slot; ``adaptive`` lets the engine pick each slot's
    depth in {1, 2, 4, .., k} from its acceptance EWMA. ``draft_arch``
    names a config of the port's registry for the draft model; ``None``
    with mode="draft" means a ``draft_layers``-deep truncation of the
    target. ``tenants`` holds per-tenant overrides: ``{"tenant_a": False}``
    turns speculation off for that tenant's requests (their slots ride the
    verify dispatch at depth 0)."""

    mode: str = "ngram"
    k: int = 8
    max_ngram: int = 8
    adaptive: bool = True
    draft_arch: Optional[str] = None
    draft_layers: int = 1
    draft_reduced: bool = False
    tenants: Mapping[str, bool] = field(default_factory=dict)

    def __post_init__(self):
        if self.mode not in ("ngram", "draft"):
            raise ValueError(f"speculate mode must be ngram|draft, got {self.mode!r}")
        if self.k < 1:
            raise ValueError(f"speculate k must be >= 1, got {self.k}")
        object.__setattr__(self, "tenants", dict(self.tenants))

    @classmethod
    def parse(cls, spec: str, **kw) -> Optional["SpeculateConfig"]:
        """CLI string -> config: ``off`` | ``ngram`` | ``draft`` |
        ``draft:<arch>`` (extra kwargs override fields)."""
        spec = spec.strip()
        if spec in ("off", "none", ""):
            return None
        if spec == "ngram":
            return cls(mode="ngram", **kw)
        if spec == "draft":
            return cls(mode="draft", **kw)
        if spec.startswith("draft:"):
            return cls(mode="draft", draft_arch=spec.split(":", 1)[1], **kw)
        raise ValueError(f"unknown --speculate value {spec!r} (off|ngram|draft[:<arch>])")

    @classmethod
    def coerce(cls, spec) -> Optional["SpeculateConfig"]:
        if spec is None or isinstance(spec, cls):
            return spec
        if isinstance(spec, str):
            return cls.parse(spec)
        raise TypeError(f"speculate must be str|SpeculateConfig|Drafter, got {type(spec)}")

    def enabled_for(self, tenant: Optional[str]) -> bool:
        if tenant is None:
            return True
        return bool(self.tenants.get(tenant, True))


@runtime_checkable
class Drafter(Protocol):
    """What the engine needs from a drafter. ``propose`` sees each slot's
    full committed context (prompt and every harvested token: the verify
    tick harvests before it drafts) and the per-slot requested depths, and
    returns per-slot proposals of at most those depths."""

    name: str

    def setup(self, device, batch_slots: int, max_len: int, vocab_size: int) -> None: ...

    def reset_slot(self, slot: int) -> None: ...

    def propose(
        self, ctxs: Sequence[Optional[np.ndarray]], depths: np.ndarray
    ) -> list[list[int]]: ...

    def prewarm(self) -> None: ...


class NGramDrafter:
    """Prompt-lookup drafter: longest-suffix n-gram match with cyclic
    extension, host-side, with no weights and no device state.

    One step finds the latest earlier occurrence of the longest suffix
    (length ``max_n`` down to 1) of the working context and copies the token
    that followed it; the proposal joins the working context before the next
    step, so a cycle unrolls to the full depth. Tokens are matched as bytes
    when the vocabulary fits in one (one ``rfind`` per suffix length), as
    int arrays otherwise."""

    name = "ngram"

    def __init__(self, max_n: int = 8):
        self.max_n = max(1, int(max_n))
        self._bytes = False

    def setup(self, device, batch_slots, max_len, vocab_size) -> None:
        self._bytes = vocab_size <= 256

    def reset_slot(self, slot: int) -> None:
        pass

    def prewarm(self) -> None:
        pass

    @staticmethod
    def _next_bytes(work: bytes, max_n: int) -> Optional[int]:
        ln = len(work)
        for n in range(min(max_n, ln - 1), 0, -1):
            suf = work[ln - n:]
            idx = work.rfind(suf, 0, ln - 1)  # an occurrence ending before the end
            if idx >= 0:
                return work[idx + n]
        return None

    @staticmethod
    def _next_ints(work: np.ndarray, max_n: int) -> Optional[int]:
        ln = len(work)
        for n in range(min(max_n, ln - 1), 0, -1):
            suf = work[ln - n:]
            win = np.lib.stride_tricks.sliding_window_view(work, n)[: ln - n]
            hits = np.flatnonzero((win == suf).all(axis=1))
            if hits.size:
                return int(work[hits[-1] + n])
        return None

    def _one(self, ctx: np.ndarray, depth: int) -> list[int]:
        out: list[int] = []
        if self._bytes:
            work = bytes(int(t) & 0xFF for t in ctx)
            for _ in range(depth):
                nxt = self._next_bytes(work, self.max_n)
                if nxt is None:
                    break
                out.append(nxt)
                work += bytes([nxt])
        else:
            work = np.asarray(ctx, np.int64)
            for _ in range(depth):
                nxt = self._next_ints(work, self.max_n)
                if nxt is None:
                    break
                out.append(nxt)
                work = np.append(work, nxt)
        return out

    def propose(self, ctxs, depths) -> list[list[int]]:
        return [
            self._one(c, int(d)) if c is not None and d > 0 else []
            for c, d in zip(ctxs, depths)
        ]


class ModelDrafter:
    """Shallow-model drafter with its own per-slot KV cache (dense, plain)
    over the engine's slot layout.

    ``propose`` first catches up: every committed context token not yet in
    the draft cache goes through one ``packed_step`` (the ragged kernel on
    the card) padded to a ``_PACK_BUCKETS`` size, whose last row per slot
    argmaxes the first draft. It then rolls greedily: ``decode_step`` (the
    decode kernel) and argmax, a power of two of steps. ``fed`` advances
    over committed tokens only; the roll's K/V past it are masked from every
    read and overwritten by the next catch-up."""

    name = "draft"

    def __init__(self, model, params):
        self.model = model
        self._params_in = params
        self.device = None

    @classmethod
    def truncated(cls, model, params, n_layers: int = 1) -> "ModelDrafter":
        """Zero-training draft: the first ``n_layers`` of the target's stack
        (embedding, those blocks, final norm) as a model of its own. The
        stacked block tensors are sliced on their layer axis as views: no
        weight is copied."""
        from repro_torch.models.model import LM

        cfg = replace(model.cfg, n_layers=n_layers)
        sliced = dict(params)
        sliced["blocks"] = _slice_layers(params["blocks"], n_layers)
        return cls(LM(cfg, device=model.device), sliced)

    # -- engine binding --------------------------------------------------
    def setup(self, device, batch_slots, max_len, vocab_size) -> None:
        if self.model.device != device:
            raise ValueError(f"draft model lives on {self.model.device}, engine on {device}")
        self.device = device
        self.B = batch_slots
        self.max_len = max_len
        self.params = self._params_in
        self.cache = self.model.init_cache(batch_slots, max_len)
        self.fed = np.zeros(batch_slots, np.int64)

    def reset_slot(self, slot: int) -> None:
        self.fed[slot] = 0

    def _put(self, arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(arr)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _catch(self, desc: torch.Tensor, out_rows: torch.Tensor) -> torch.Tensor:
        logits, _ = self.model.packed_step(
            self.params, self.cache, desc[0], desc[1], desc[2], out_rows=out_rows
        )
        return logits.float().argmax(dim=-1).to(torch.int32)

    def _roll(self, tok, cl, act, n_steps: int) -> torch.Tensor:
        """``n_steps`` greedy draft steps from ``tok`` at lengths ``cl``;
        slots with ``act`` 0 keep their token and length. Returns [n, B]."""
        live = act.bool()
        toks = []
        for _ in range(n_steps):
            logits, _ = self.model.decode_step(self.params, self.cache, {"tokens": tok[:, None]},
                                               cl)
            nt = logits[:, 0].float().argmax(dim=-1).to(torch.int32)
            tok = torch.where(live, nt, tok)
            cl = cl + act
            toks.append(tok)
        return torch.stack(toks)

    def _pack(self, entries, tb: int) -> torch.Tensor:
        desc = np.zeros((3, tb), np.int32)
        desc[2] = self.max_len  # padding rows: dropped scatters
        for t, (tok, sl, pos) in enumerate(entries):
            desc[:, t] = (tok, sl, pos)
        return self._put(desc)

    def prewarm(self) -> None:
        """Run the steady-state catch-up buckets and every roll depth once
        (an idle engine: slot 0's position 0 takes a dummy row, refed by the
        slot's first catch-up)."""
        z = self._put(np.zeros(self.B, np.int32))
        for tb in [b for b in _PACK_BUCKETS if b <= _bucket(4 * self.B)]:
            self._catch(self._pack([(0, 0, 0)], tb), z)
        n = 1
        while n <= 8:
            self._roll(z, z, z, n)
            n *= 2
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def propose(self, ctxs, depths) -> list[list[int]]:
        out: list[list[int]] = [[] for _ in range(self.B)]
        live = [i for i in range(self.B) if ctxs[i] is not None and int(depths[i]) > 0]
        if not live:
            return out
        # catch-up pack: every committed-but-unfed token; a slot's last fed
        # row predicts its next position (the first draft)
        entries: list[tuple[int, int, int]] = []
        out_rows = np.zeros(self.B, np.int32)
        roll_cl = np.zeros(self.B, np.int32)
        act = np.zeros(self.B, np.int32)
        for i in live:
            c = ctxs[i]
            ln = len(c)
            fed = int(self.fed[i])
            if not 0 < fed <= ln:
                fed = 0  # slot reused: refeed from scratch
            if fed == ln:
                fed = ln - 1  # nothing new: refeed the last token (idempotent)
            for pos in range(fed, ln):
                entries.append((int(c[pos]), i, pos))
            out_rows[i] = len(entries) - 1
            roll_cl[i] = ln
            act[i] = 1
            self.fed[i] = ln
        first = self._catch(self._pack(entries, _bucket(len(entries))), self._put(out_rows))
        maxd = max(int(depths[i]) for i in live)
        if maxd > 1:
            n = 1
            while n < maxd - 1:
                n *= 2
            rolls = self._roll(first, self._put(roll_cl), self._put(act), n)
            both = torch.cat([first[None], rolls]).cpu().numpy()  # one transfer
            first_h, rolls_h = both[0], both[1:]
        else:
            first_h = first.cpu().numpy()
            rolls_h = np.zeros((0, self.B), np.int32)
        for i in live:
            d = int(depths[i])
            out[i] = [int(first_h[i])] + [int(t) for t in rolls_h[: d - 1, i]]
        return out


def _slice_layers(tree, n: int):
    if isinstance(tree, dict):
        return {k: _slice_layers(v, n) for k, v in tree.items()}
    return tree[:n]


def build_drafter(cfg: SpeculateConfig, model, params) -> Drafter:
    """The drafter of a :class:`SpeculateConfig`.

    ``mode="draft"`` with ``draft_arch=None`` truncates the target's own
    params (no extra weights). With an arch name it builds that config of
    the port's registry, random-initialised by ``LM.init`` from a generator
    seeded 0 on the model's device. Those weights differ from the JAX
    package's draft (``jax.random.key(0)``), so the proposals and the
    acceptance counts differ from JAX's; the stream does not, because
    acceptance is exact match."""
    if cfg.mode == "ngram":
        return NGramDrafter(max_n=cfg.max_ngram)
    if cfg.draft_arch is None:
        return ModelDrafter.truncated(model, params, n_layers=cfg.draft_layers)
    from repro_torch.configs import get_arch
    from repro_torch.models.model import LM

    dcfg = get_arch(cfg.draft_arch)
    if cfg.draft_reduced:
        dcfg = dcfg.reduced()
    if dcfg.vocab_size != model.cfg.vocab_size:
        raise ValueError(
            f"draft arch {cfg.draft_arch!r} vocab {dcfg.vocab_size} != "
            f"target vocab {model.cfg.vocab_size}"
        )
    dmodel = LM(dcfg, device=model.device)
    return ModelDrafter(dmodel, dmodel.init(torch.Generator(device=model.device).manual_seed(0)))
