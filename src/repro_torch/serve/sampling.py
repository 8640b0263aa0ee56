"""Request-level sampling configuration and the device-side fused sampler
(counterpart of ``repro/serve/sampling.py``).

:class:`SamplingParams` is the JAX package's record, unchanged, so a request
means the same thing to both engines. The engine keeps per-slot parameter
rows on the device (:func:`param_rows`) and each dispatch runs one sampler
variant (``smode``), the widest any of its slots needs:

* ``SMODE_GREEDY`` (0): argmax only, with no PRNG, no bias scatter and no
  sort;
* ``SMODE_GUMBEL`` (1): gumbel-max at each slot's temperature;
* ``SMODE_MASKED`` (2): logit bias, then temperature, then the joint
  top-k / top-p keep mask, then gumbel-max over the kept tokens.

Every draw is keyed ``fold_in(key(seed), position)`` (:mod:`.prng`, bitwise
``jax.random``'s), a pure function of the request's seed and the position
sampled, so a seeded stream does not depend on chunk sizes, on speculation
or on its neighbours. The sort and the cumulative sum over the vocabulary
are PyTorch calls, as the JAX sampler is plain jnp.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Optional

import numpy as np
import torch

from repro_torch.serve import prng

# sampler dispatch variants, as in the JAX package
SMODE_GREEDY, SMODE_GUMBEL, SMODE_MASKED = 0, 1, 2

MAX_LOGIT_BIAS = 8

# token id of an unused bias lane: outside any vocabulary, so dropped
_BIAS_PAD = 2**30


@dataclass(frozen=True)
class SamplingParams:
    """Frozen per-request sampling/termination configuration.

    ``temperature <= 0`` means greedy (argmax). ``top_k=0`` and
    ``top_p=1.0`` disable their masks. ``seed=None`` lets the engine draw
    one at admission from its own ``seed``. ``stop`` token ids terminate the
    stream (the stop token itself is emitted). ``logit_bias`` is up to
    ``MAX_LOGIT_BIAS`` ``(token_id, bias)`` pairs added to the logits before
    every decision, greedy included."""

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: Optional[int] = None
    max_new: int = 16
    stop: tuple[int, ...] = ()
    logit_bias: tuple[tuple[int, float], ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "stop", tuple(int(t) for t in self.stop))
        lb = self.logit_bias
        if isinstance(lb, Mapping):
            lb = tuple(lb.items())
        object.__setattr__(self, "logit_bias", tuple((int(t), float(v)) for t, v in lb))
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0 (0 disables), got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {self.max_new}")
        if self.seed is not None and not -(2**31) <= self.seed < 2**31:
            raise ValueError(f"seed must fit int32, got {self.seed}")
        if len(self.logit_bias) > MAX_LOGIT_BIAS:
            raise ValueError(
                f"at most {MAX_LOGIT_BIAS} logit_bias entries, got {len(self.logit_bias)}"
            )

    @property
    def smode(self) -> int:
        """The narrowest sampler variant this request needs."""
        if self.temperature <= 0 and not self.logit_bias:
            return SMODE_GREEDY
        if self.top_k == 0 and self.top_p >= 1.0 and not self.logit_bias:
            return SMODE_GUMBEL
        return SMODE_MASKED


def bias_row(params: SamplingParams) -> tuple[np.ndarray, np.ndarray]:
    """One request's ``(tokens, values)`` bias row, padded to static shape."""
    bt = np.full(MAX_LOGIT_BIAS, _BIAS_PAD, np.int32)
    bv = np.zeros(MAX_LOGIT_BIAS, np.float32)
    for j, (t, v) in enumerate(params.logit_bias):
        bt[j], bv[j] = t, v
    return bt, bv


def param_rows(slot_params, seeds) -> tuple[np.ndarray, ...]:
    """Per-slot parameter rows of a slot pool: ``slot_params`` a list of
    ``Optional[SamplingParams]`` (None: a free slot), ``seeds`` the resolved
    seeds. Returns ``(spf [2, B] f32, spi [2, B] i32, bias_tok [B, K] i32,
    bias_val [B, K] f32)``, rows (temperature, top_p) and (top_k, seed)."""
    b = len(slot_params)
    spf = np.zeros((2, b), np.float32)
    spf[1] = 1.0
    spi = np.zeros((2, b), np.int32)
    btok = np.full((b, MAX_LOGIT_BIAS), _BIAS_PAD, np.int32)
    bval = np.zeros((b, MAX_LOGIT_BIAS), np.float32)
    for i, p in enumerate(slot_params):
        if p is None:
            continue
        spf[0, i] = p.temperature
        spf[1, i] = p.top_p
        spi[0, i] = p.top_k
        spi[1, i] = seeds[i]
        btok[i], bval[i] = bias_row(p)
    return spf, spi, btok, bval


def _fold_keys(seeds: torch.Tensor, pos: torch.Tensor):
    """Per-row PRNG keys ``fold_in(key(seed), position)``: a pure function
    of (request seed, absolute position)."""
    return prng.fold_in(prng.key(seeds), pos)


def _add_bias(logits: torch.Tensor, bias_tok: torch.Tensor, bias_val: torch.Tensor) -> None:
    """``logits.at[rows, bias_tok].add(bias_val, mode="drop")`` in place.

    The rule of the JAX scatter (measured under jax 0.9): an id in [-V, V)
    is taken mod V (so -1 is the last token), any other id (the 2**30
    padding among them) is dropped, and duplicate ids add in lane order,
    ``(l + b1) + b2``. The lanes go one at a time, so the order holds on the
    card too; a dropped lane adds 0 to token 0."""
    v = logits.shape[-1]
    tok = bias_tok.to(torch.int64)
    kept = (tok >= -v) & (tok < v)
    tok = torch.where(kept, torch.remainder(tok, v), 0)
    val = torch.where(kept, bias_val.to(torch.float32), 0.0)
    for j in range(tok.shape[1]):
        logits.scatter_add_(1, tok[:, j:j + 1], val[:, j:j + 1])


def _keep_mask(scaled: torch.Tensor, top_k: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """Joint top-k/top-p keep mask over temperature-scaled logits [B, V].

    One descending sort serves both: the k-th largest value thresholds
    top-k (``top_k=0`` keeps all; ties at the threshold are kept), and the
    smallest value whose exclusive cumulative softmax mass is still below
    ``top_p`` thresholds the nucleus (so at least one token survives).

    ``top_p >= 1`` keeps every token, as in exact arithmetic: the float32
    exclusive sums of the tail may round up to 1.0 (torch's CPU cumsum
    accumulates in float64 and rounds each sum, XLA's adds in a tree), and
    would then drop tail tokens in one implementation and not the other."""
    v = scaled.shape[-1]
    srt = torch.sort(scaled, dim=-1, descending=True).values
    k = top_k.to(torch.int64)
    k_eff = torch.clamp(torch.where(k > 0, k, v), 1, v)
    kth = srt.gather(1, k_eff[:, None] - 1)
    keep = scaled >= kth
    probs = torch.softmax(srt, dim=-1)
    cum_excl = torch.cumsum(probs, dim=-1) - probs
    top_p = top_p.to(torch.float32)
    n_keep = torch.clamp_min((cum_excl < top_p[:, None]).sum(-1), 1)
    n_keep = torch.where(top_p >= 1.0, v, n_keep)
    pth = srt.gather(1, n_keep[:, None] - 1)
    return keep & (scaled >= pth)


def fused_sample(logits: torch.Tensor, temps=None, top_k=None, top_p=None, seeds=None,
                 pos=None, bias_tok=None, bias_val=None, *,
                 smode: int = SMODE_GREEDY) -> torch.Tensor:
    """One sampling decision per row of ``logits`` [B, V], on the logits'
    device, as int32 [B]. temps/top_p [B] f32, top_k/seeds/pos [B] int32,
    bias_tok/bias_val [B, MAX_LOGIT_BIAS]; smode 0 reads none of them.

    smode 0 is argmax in f32 (first index on ties, as ``jnp.argmax``);
    smode 1 gumbel-max at each row's temperature; smode 2 adds the logit
    bias and masks top-k/top-p before the draw. A row with ``temps <= 0``
    takes the argmax of its (biased) logits whatever the smode."""
    logits = logits.to(torch.float32)
    if smode == SMODE_GREEDY:
        return logits.argmax(dim=-1).to(torch.int32)
    if smode not in (SMODE_GUMBEL, SMODE_MASKED):
        raise ValueError(f"unknown smode {smode}")
    if smode == SMODE_MASKED:
        logits = logits.clone()
        _add_bias(logits, bias_tok, bias_val)
    greedy = logits.argmax(dim=-1).to(torch.int32)
    gumbel = prng.gumbel(_fold_keys(seeds, pos), logits.shape[-1])
    scaled = logits / torch.clamp_min(temps.to(torch.float32), 1e-6)[:, None]
    if smode == SMODE_MASKED:
        scaled = torch.where(_keep_mask(scaled, top_k, top_p), scaled, -torch.inf)
    sampled = (scaled + gumbel).argmax(dim=-1).to(torch.int32)
    return torch.where(temps > 0, sampled, greedy)


def spec_verify(logits, drafts, depth, active, temps, top_k, top_p, seeds, pos0,
                bias_tok, bias_val, *, smode: int):
    """Draft-and-verify acceptance over one packed verify dispatch, built on
    :func:`fused_sample` so verified and sequential tokens cannot differ.

    ``logits`` [B*(K+1), V] are the slot-major rows ``[last_token, draft_1
    .. draft_K]``: row (i, j) predicts position ``pos0[i] + j + 1`` and is
    sampled with PRNG position ``pos0[i] + j``. ``drafts`` [B, K] int32,
    ``depth``/``active``/``pos0`` [B] int32, the sampler rows per slot (as
    :func:`param_rows`; repeated over each slot's K+1 rows here).

    Acceptance is exact match: every draw is a pure function of (context,
    seed, position), so the target at each position is one token and a
    draft is accepted only where it equals it. Returns ``(targets [B, K+1],
    n_accept [B], commit [B])``: ``n_accept`` the leading run of drafts
    equal to their targets, within ``depth``; ``commit = n_accept + 1`` for
    an active slot (the run and the token sampled after it) and 0
    otherwise."""
    b, k = drafts.shape
    w = k + 1
    ar = torch.arange(w, dtype=pos0.dtype, device=pos0.device)
    pos = (pos0[:, None] + ar[None, :]).reshape(-1)

    def rep(a):
        return None if a is None else a.repeat_interleave(w, dim=0)

    targets = fused_sample(
        logits, rep(temps), rep(top_k), rep(top_p), rep(seeds), pos,
        rep(bias_tok), rep(bias_val), smode=smode,
    ).view(b, w)
    if k:
        lane = torch.arange(k, device=drafts.device)
        match = (targets[:, :k] == drafts) & (lane[None, :] < depth[:, None])
        n_accept = torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1).to(torch.int32)
    else:
        n_accept = torch.zeros(b, dtype=torch.int32, device=drafts.device)
    commit = torch.where(active.bool(), n_accept + 1, 0).to(torch.int32)
    return targets, n_accept, commit
