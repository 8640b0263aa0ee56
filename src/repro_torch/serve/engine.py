"""Batched serving engine with continuous batching and the unified ragged
prefill+decode dispatch (counterpart of ``repro/serve/engine.py`` with
``unified=True``, dense cache, greedy sampling).

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
  (≤ ``max_chunk``) greedy steps in one dispatch, where ``k`` is the largest
  power of two in which no slot can finish (``LM.decode_step`` → the decode
  kernel). Inactive slots (empty or mid-prefill) ride along without
  advancing their length or changing their last token.

Tick state (last tokens, per-slot lengths) lives on the device; the host
tracks counts only and reads dispatch t-1's token values after dispatch t is
enqueued, so the transfer overlaps device work. Host arrays reach the card
through pinned memory without a stream synchronisation. The KV cache is
updated in place (the JAX engine donates it). Not ported: the legacy
prefill+insert tier, paging, quantization, speculation, sampled (non-greedy)
requests, the placement backends and the cluster hooks.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.model import LM
from repro_torch.serve.sampling import SMODE_GREEDY, SamplingParams, fused_sample


@dataclass(eq=False)
class Request:
    """One serving request (identity-based equality: a live lifecycle object)."""

    rid: int
    prompt: np.ndarray  # [S] int32
    params: SamplingParams = field(default_factory=SamplingParams)
    generated: list[int] = field(default_factory=list)
    n_generated: int = 0  # tokens sampled so far (values may still be in flight)
    submitted_at: float = 0.0
    first_token_at: Optional[float] = None
    done_at: Optional[float] = None
    finish_reason: Optional[str] = None  # "length" | "stop" | "cancelled"

    @property
    def complete(self) -> bool:
        """Finished AND every token value harvested to the host."""
        return self.finish_reason is not None and len(self.generated) >= self.n_generated


class RequestHandle:
    """Streaming view of one submitted request: an incremental token
    iterator (driving the engine when needed) plus ``cancel()``."""

    def __init__(self, request: Request, owner: "ServeEngine") -> None:
        self.request = request
        self._owner = owner

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
    kv_bytes_resident: int = 0
    # per-request samples of the requests finished in this run: TTFT = first
    # token on the host - submitted; TPOT = mean inter-token time
    ttfts: list[float] = field(default_factory=list)
    tpots: list[float] = field(default_factory=list)

    @property
    def tokens_per_sec(self) -> float:
        return self.total_tokens / max(self.wall_seconds, 1e-9)

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
        prefill_budget: int = 64,
        max_chunk: int = 8,
        device=None,
    ):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, engine on {self.device}")
        if params["final_norm"].device != self.device:
            raise ValueError(f"params live on {params['final_norm'].device}, engine on {self.device}")
        self.model = model
        self.params = params
        self.B = batch_slots
        self.max_len = max_len
        self.prefill_budget = max(int(prefill_budget), 1)
        self.max_chunk = max(int(max_chunk), 1)
        self.cache = model.init_cache(batch_slots, max_len)
        self.slot_req: list[Optional[Request]] = [None] * batch_slots
        self.slot_len = np.zeros(batch_slots, np.int32)  # host mirror (counts)
        self.slot_fed = np.zeros(batch_slots, np.int32)  # prompt tokens fed
        self.waiting: deque[Request] = deque()
        self.finished: list[Request] = []
        self._prefilling: list[int] = []  # slots mid-prefill, admission order
        self._done_now: list[Request] = []  # requests finished in this run()
        self._pending: deque = deque()  # dispatched, not yet harvested
        self._cancels: list[Request] = []
        self._running = False
        self._stream_stats = ServeStats()  # step()-driven serving
        # device-resident tick state and the per-slot "decoding" lane
        dev = self.device
        self._slot_ids = torch.arange(batch_slots, dtype=torch.int32, device=dev)
        self._last_tok = torch.zeros(batch_slots, dtype=torch.int32, device=dev)
        self._cur_len = torch.zeros(batch_slots, dtype=torch.int32, device=dev)
        self._active = torch.zeros(batch_slots, dtype=torch.int32, device=dev)
        self._dirty = False  # slot set changed: the active lane must re-upload

    # ------------------------------------------------------------ transfers

    def _put(self, arr: np.ndarray) -> torch.Tensor:
        """Host array -> device. On the card through pinned memory, so the
        copy is queued without waiting for earlier work on the stream. The
        caller hands a fresh array it never mutates afterwards."""
        t = torch.from_numpy(arr)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    # ------------------------------------------------------------- dispatches

    def _tick_fn(self, last_tok, cur_len, active, n_steps: int):
        """One decode chunk: ``n_steps`` decode + greedy-sample steps for
        every slot. Inactive slots keep their ``last_tok`` and length (their
        garbage K/V row at ``cur_len`` is rewritten before anything reads
        it). Returns (toks [n_steps, B], last_tok, cur_len)."""
        act = active.bool()
        tok, cl = last_tok, cur_len
        toks = []
        for _ in range(n_steps):
            logits, _ = self.model.decode_step(self.params, self.cache, {"tokens": tok[:, None]}, cl)
            tok = torch.where(act, fused_sample(logits[:, 0]), tok)
            cl = cl + active
            toks.append(tok)
        return torch.stack(toks), tok, cl

    def _packed_fn(self, last_tok, pack, tb: int):
        """One ragged pack. ``pack`` is one int32 upload: the [3, tb]
        descriptor rows (token, local slot, position) then meta = new_len
        [B] | sample_idx [B] | sample_mask [B] | pack_slots [_PACK_WIDTH].
        A slot whose prompt completes samples its first token from its final
        prompt row. Returns (sampled [B], last_tok, cur_len = new_len)."""
        b = self.B
        desc = pack[: 3 * tb].view(3, tb)
        meta = pack[3 * tb:]
        new_len = meta[:b]
        sample_idx = meta[b: 2 * b]
        sample_mask = meta[2 * b: 3 * b].bool()
        pack_slots = meta[3 * b:]
        logits, _ = self.model.packed_step(
            self.params, self.cache, desc[0], desc[1], desc[2],
            out_rows=sample_idx, pack_slots=pack_slots, max_len=self.max_len,
        )
        sampled = fused_sample(logits)
        return sampled, torch.where(sample_mask, sampled, last_tok), new_len

    def _admit_fn(self, toks, slot: int, last_pos: int, last_tok, cur_len):
        """One fused admission: prefill the bucket-padded prompt into the
        slot's cache rows, sample the first token from the last REAL prompt
        position, and set the slot's tick state. Returns (tok, last_tok,
        cur_len)."""
        logits, _ = self.model.prefill(
            self.params, {"tokens": toks}, self.max_len, cache=self.cache, slot=slot
        )
        tok = fused_sample(logits[0, last_pos][None])[0]
        hit = self._slot_ids == slot
        return tok, torch.where(hit, tok, last_tok), torch.where(hit, last_pos + 1, cur_len)

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

    def prewarm(self) -> None:
        """Build the kernels and run one dummy dispatch per route (decode
        chunk, ragged pack, fused admission) off the clock. Results are
        discarded and the tick state is untouched; call on an IDLE engine:
        the dummies write garbage into cache rows nothing reads yet."""
        idle = torch.zeros(self.B, dtype=torch.int32, device=self.device)
        self._tick_fn(self._last_tok, self._cur_len, idle, 1)
        tb = _T_BUCKETS[0]
        desc = np.zeros((3, tb), np.int32)
        desc[2, 1:] = self.max_len  # token 0 at row 0 of slot 0, then padding
        meta = np.concatenate([self.slot_len, np.zeros(2 * self.B + _PACK_WIDTH, np.int32)])
        self._packed_fn(self._last_tok, self._put(np.concatenate([desc.ravel(), meta])), tb)
        self._admit_fn(self._put(np.zeros((1, 1), np.int32)), 0, 0, self._last_tok, self._cur_len)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def submit(self, req: Request) -> RequestHandle:
        if len(req.prompt) >= self.max_len:
            raise ValueError(f"prompt of {len(req.prompt)} tokens needs max_len > that")
        if req.params.smode != SMODE_GREEDY:
            raise NotImplementedError("only greedy requests are ported (smode 0)")
        req.submitted_at = time.perf_counter()
        self.waiting.append(req)
        return RequestHandle(req, self)

    def cancel(self, req: Request) -> None:
        """Abort a request: dequeue it if waiting, free its slot if admitted.
        In-flight token values are discarded; no other slot is perturbed.
        Applied now, or at the next iteration boundary inside ``run()``."""
        self._cancels.append(req)
        if not self._running:
            self._apply_cancels(self._stream_stats)

    def _apply_cancels(self, stats: ServeStats) -> None:
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
        if stats is not None:
            stats.total_requests += 1
        self._dirty = True

    def _admit_unified(self, stats: ServeStats) -> None:
        """Bind waiting requests to free slots: short prompts take the fused
        admission now, longer ones join the chunked pack tier."""
        for slot in range(self.B):
            while self.slot_req[slot] is None and self.waiting:
                req = self.waiting.popleft()
                s = len(req.prompt)
                self.slot_req[slot] = req
                self._dirty = True
                if s > self.prefill_budget:
                    self.slot_len[slot] = 0
                    self.slot_fed[slot] = 0
                    self._prefilling.append(slot)
                    continue
                sb = _bucket_len(s, self.max_len)
                toks = np.zeros((1, sb), np.int32)
                toks[0, :s] = req.prompt
                tok, self._last_tok, self._cur_len = self._admit_fn(
                    self._put(toks), slot, s - 1, self._last_tok, self._cur_len
                )
                self.slot_len[slot] = s
                self.slot_fed[slot] = s
                req.n_generated += 1  # the first token, in flight
                self._pending.append(("admit", tok, (slot, req), stats))
                if req.n_generated >= req.params.max_new:
                    self._finish(req, slot, stats)

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
        toks, self._last_tok, self._cur_len = self._packed_fn(
            self._last_tok, self._put(np.concatenate([desc.ravel(), meta])), tb
        )
        stats.ticks += 1
        if completed:
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
        toks, self._last_tok, self._cur_len = self._tick_fn(
            self._last_tok, self._cur_len, self._flush_events(), k
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

    def _service_once(self, stats: ServeStats) -> bool:
        """ONE scheduling iteration: apply cancellations, release
        stop-finished slots, admit, dispatch a pack (if any admission is
        mid-prefill) and a decode chunk, then harvest everything older than
        the newest dispatch. Returns whether any work remains."""
        self._apply_cancels(stats)
        self._release_stopped(stats)
        self._admit_unified(stats)
        stats.kv_bytes_resident = max(stats.kv_bytes_resident, self.kv_bytes_resident())
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active:
            self._drain_pending()
            self._release_stopped(stats)
            return bool(self.waiting) or any(r is not None for r in self.slot_req)
        if self._prefilling:
            self._packed_tick(stats)
            decoding = [
                i for i, r in enumerate(self.slot_req)
                if r is not None and self.slot_fed[i] >= len(r.prompt)
            ]
            if decoding:
                self._chunk_tick(stats, decoding)
        else:
            self._chunk_tick(stats, active)
        while len(self._pending) > 1:
            self._harvest(self._pending.popleft())
        return True

    def kv_bytes_resident(self) -> int:
        """Bytes of the dense KV cache (every slot's worst case is resident)."""
        return sum(t.numel() * t.element_size() for t in self.cache.values())

    @property
    def stream_stats(self) -> ServeStats:
        """Stats of step()-driven serving (handle iterators, inline cancels)."""
        return self._stream_stats

    def step(self) -> bool:
        """Advance by one scheduling iteration; returns whether work remains."""
        busy = self._service_once(self._stream_stats)
        if not busy:
            self._drain_pending()
            self._release_stopped(self._stream_stats)
        return busy

    def _handle_pump(self, req: Request) -> None:
        if self.step():
            return
        self._apply_cancels(self._stream_stats)
        if not req.complete:
            raise RuntimeError(
                f"engine idle but request {req.rid} incomplete — was it submitted here?"
            )

    def run(self, arrivals=None) -> ServeStats:
        """Drain all submitted requests; returns throughput + latency stats.
        ``arrivals`` optionally replays an open-loop stream of
        ``(t_offset_seconds, Request)``, each submitted once the run clock
        passes its offset (its TTFT clock starts at the scheduled time)."""
        stats = ServeStats()
        self._done_now = []
        t0 = time.perf_counter()
        arr: deque = deque(sorted(arrivals, key=lambda a: a[0]) if arrivals else ())
        self._running = True
        try:
            while True:
                now = time.perf_counter() - t0
                while arr and arr[0][0] <= now:
                    t_off, req = arr.popleft()
                    self.submit(req)
                    req.submitted_at = t0 + t_off
                stats.queue_peak = max(stats.queue_peak, len(self.waiting))
                if not (any(r is not None for r in self.slot_req)
                        or self.waiting or arr or self._cancels):
                    break
                busy = self._service_once(stats)
                if not busy and arr:
                    wait = arr[0][0] - (time.perf_counter() - t0)
                    if wait > 0:
                        time.sleep(min(wait, 0.001))
            self._drain_pending()
            self._release_stopped(stats)
        finally:
            self._running = False
        stats.wall_seconds = time.perf_counter() - t0
        stats.kv_bytes_resident = max(stats.kv_bytes_resident, self.kv_bytes_resident())
        for req in self._done_now:
            if req.first_token_at is not None:
                stats.ttfts.append(req.first_token_at - req.submitted_at)
                if req.done_at is not None and req.n_generated >= 2:
                    stats.tpots.append(
                        max(req.done_at - req.first_token_at, 0.0) / (req.n_generated - 1)
                    )
        return stats
