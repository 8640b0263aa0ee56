"""Serving launcher: continuous batching on one engine or a reconfigurable
split/merge cluster over lanes (counterpart of ``repro/launch/serve.py``,
with its flags and its printed lines).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch codeqwen1.5-7b \
      --reduced --requests 16 --slots 4 --max-new 32

  # two lanes of one card (a device and a stream of its own each): split
  # replicas, or one tensor-parallel engine over both
  ... -m repro_torch.launch.serve --arch codeqwen1.5-7b --reduced \
      --cluster-mode merge --devices cuda:0,cuda:0

  # the plain PyTorch path on the CPU, two lanes
  ... -m repro_torch.launch.serve --arch codeqwen1.5-7b --reduced \
      --cluster-mode merge --devices cpu,cpu

  # heterogeneous: different models pinned per split replica, requests
  # round-robined across them (the router dispatches by model name):
  ... -m repro_torch.launch.serve --reduced --model chat=minicpm3-4b \
      --model bulk=falcon-mamba-7b --cluster-mode split --devices cuda:0,cuda:0

  # closed-loop: serve under a ReconfigController that switches split<->
  # merge mid-stream when the perfmodel-predicted win clears switch cost:
  ... -m repro_torch.launch.serve --arch codeqwen1.5-7b --reduced --cluster-mode auto

Where the JAX launcher reads ``jax.devices()``, this one takes ``--devices``
(comma-separated torch devices, one lane each; default: every CUDA device).
Params are ``LM.init`` of a generator on the first device seeded by
``--seed``.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_arch
from repro_torch.core.modes import Mode
from repro_torch.models import LM
from repro_torch.serve import (
    AdmissionPolicy,
    AdmissionRejected,
    Request,
    SamplingParams,
    ServeCluster,
    ServeEngine,
    SpeculateConfig,
)


def _resolve_auto(n_devices: int, n_requests: int, slots: int) -> str:
    """``--cluster-mode auto`` over one lane degenerates to a single engine;
    over several the STARTING mode matches the workload (many independent
    requests want split replicas, few large ones want the merged wide
    engine) and a ReconfigController owns every switch after that — auto
    serves through ``run_controlled``, the paper's closed control loop, not
    a one-shot static guess."""
    if n_devices <= 1:
        return "single"
    return "split" if n_requests >= 2 * slots else "merge"


def _parse_models(pairs: list[str], ap: argparse.ArgumentParser) -> dict[str, str]:
    """``--model name=arch`` pairs -> ordered {name: arch}; the first
    entry is the cluster's primary model (unpinned requests land there)."""
    out: dict[str, str] = {}
    for pair in pairs:
        name, sep, arch = pair.partition("=")
        if not sep or not name or not arch:
            ap.error(f"--model wants NAME=ARCH, got {pair!r}")
        if name in out:
            ap.error(f"--model names {name!r} twice")
        out[name] = arch
    return out


def _parse_devices(spec: Optional[str]) -> list[torch.device]:
    """``--devices`` -> one torch device a lane (an entry may repeat);
    None is every CUDA device (raising without one)."""
    if spec is None:
        resolve_device(None)  # raises without a card
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [resolve_device(d.strip()) for d in spec.split(",") if d.strip()]


def main(argv: Optional[Sequence[str]] = None):
    """Run the launcher on ``argv`` (default: the command line); returns the
    engine or the cluster that served."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None)
    ap.add_argument(
        "--model", action="append", default=None, metavar="NAME=ARCH",
        help="heterogeneous serving: repeat to pin several named models "
        "onto one split cluster (one model per replica, cost-weighted "
        "placement); requests round-robin across the names and the router "
        "dispatches each to its model's replicas. Mutually exclusive with "
        "--arch; needs a split-capable cluster mode",
    )
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument(
        "--devices", default=None,
        help="comma-separated torch devices, one lane each; a device may "
        "repeat (cuda:0,cuda:0: two lanes of one card; cpu,cpu: two lanes "
        "on the CPU). Default: every CUDA device",
    )
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--prompt-len", type=int, default=16)
    # per-request sampling configuration (one SamplingParams for the whole
    # synthetic stream; a real deployment would vary these per request)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0, help="0 disables")
    ap.add_argument("--top-p", type=float, default=1.0, help="1.0 disables")
    ap.add_argument(
        "--sample-seed", type=int, default=None,
        help="per-request PRNG seed base (request i uses seed+i); default: "
        "engine-assigned",
    )
    ap.add_argument(
        "--stop", type=int, nargs="*", default=(),
        help="stop token id(s): streams terminate at (and include) the first hit",
    )
    ap.add_argument(
        "--stream", action="store_true",
        help="stream request 0's tokens incrementally through its "
        "RequestHandle (the other requests decode alongside), then drain",
    )
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--cluster-mode", choices=("single", "split", "merge", "auto"),
        default="single",
        help="single: one engine on the first device; split: one engine "
        "replica per lane behind the JSQ router; merge: one tensor-"
        "parallel engine over every lane; auto: pick by workload shape",
    )
    eng_sel = ap.add_mutually_exclusive_group()
    eng_sel.add_argument(
        "--unified", dest="unified", action="store_true", default=None,
        help="force the unified ragged prefill+decode dispatch",
    )
    eng_sel.add_argument(
        "--legacy", dest="unified", action="store_false",
        help="force the legacy synchronous-prefill engine",
    )
    ap.add_argument(
        "--no-prewarm", action="store_true",
        help="skip prewarm(): kernel builds land inside the timed region",
    )
    ap.add_argument(
        "--kv-block-size", type=int, default=None,
        help="enable block-paged KV serving with this block size (tokens "
        "per block; must divide --max-len). Default: dense per-slot cache",
    )
    ap.add_argument(
        "--num-blocks", type=int, default=None,
        help="KV pool size in blocks (paged mode). Default: byte parity "
        "with the dense cache (slots * max_len / block_size); smaller "
        "pools oversubscribe and make admission wait on pool pressure",
    )
    ap.add_argument(
        "--prefix-cache", action="store_true",
        help="radix prefix reuse across requests (requires --kv-block-size)",
    )
    ap.add_argument(
        "--speculate", default="off",
        help="speculative decoding: 'off' (default), 'ngram' (prompt-lookup "
        "drafter, zero extra weights), 'draft' (1-layer truncated-self "
        "draft model) or 'draft:<arch>' (separate draft architecture). "
        "Output is bit-identical to --speculate off for seeded requests",
    )
    ap.add_argument(
        "--spec-k", type=int, default=None,
        help="max speculation depth (proposed tokens per slot per verify "
        "dispatch); default 8, adaptively shrunk per slot by acceptance",
    )
    ap.add_argument(
        "--kv-dtype", choices=("f32", "int8", "fp8"), default="f32",
        help="KV cache storage dtype: f32 (default: the plain cache), int8, "
        "or fp8 (float8_e4m3fn) — rows quantized at insert time with "
        "per-(position, head) f32 scales, widened inside the attention "
        "kernels",
    )
    ap.add_argument(
        "--weight-dtype", choices=("f32", "int8"), default="f32",
        help="matmul weight storage dtype: f32 (default: the model dtype) or "
        "int8 with per-output-channel scales (norms/embeddings stay dense)",
    )
    ap.add_argument(
        "--max-queue", type=int, default=None,
        help="admission control (cluster modes): bound each replica's wait "
        "queue; arrivals beyond it are rejected 'queue_full' instead of "
        "growing TTFT without bound",
    )
    ap.add_argument(
        "--deadline-s", type=float, default=None,
        help="admission control (cluster modes): per-request TTFT deadline; "
        "arrivals whose predicted TTFT exceeds it are shed up front "
        "('shed_deadline') rather than served hopelessly late",
    )
    args = ap.parse_args(argv)
    if args.prefix_cache and not args.kv_block_size:
        ap.error("--prefix-cache requires --kv-block-size")
    if (args.arch is None) == (args.model is None):
        ap.error("pass exactly one of --arch or --model NAME=ARCH")
    admission_on = args.max_queue is not None or args.deadline_s is not None
    if admission_on and args.cluster_mode == "single":
        ap.error("--max-queue/--deadline-s need a cluster mode (admission "
                 "control lives at the cluster layer)")
    devices = _parse_devices(args.devices)
    if not devices:
        ap.error("--devices names no device")

    def build(arch: str, seed: int):
        cfg = get_arch(arch)
        if args.reduced:
            cfg = cfg.reduced()
        model = LM(cfg, device=devices[0])
        return cfg, model, model.init(torch.Generator(device=devices[0]).manual_seed(seed))

    named = None  # {name: (cfg, LM, params)} when --model pairs were given
    if args.model is not None:
        named = {
            name: build(arch, args.seed + i)
            for i, (name, arch) in enumerate(_parse_models(args.model, ap).items())
        }
        cfg, model, params = next(iter(named.values()))  # primary model
    else:
        cfg, model, params = build(args.arch, args.seed)

    hetero = named is not None and len(named) > 1
    controlled = False  # auto: serve under a ReconfigController
    mode = args.cluster_mode
    if mode == "auto":
        mode = _resolve_auto(len(devices), args.requests, args.slots)
        controlled = mode != "single" and not hetero  # hetero stays split
        if hetero:
            mode = "split"
        print(f"cluster-mode auto -> {mode}"
              + (" (closed-loop run_controlled)" if controlled else ""))
    if hetero and mode != "split":
        ap.error("--model with several names is split-only (one model per "
                 "replica; merge cannot fuse different parameterizations)")
    if admission_on and mode == "single":
        ap.error("--max-queue/--deadline-s need a cluster mode (admission "
                 "control lives at the cluster layer)")
    spec_kw = {} if args.spec_k is None else {"k": args.spec_k}
    speculate = SpeculateConfig.parse(args.speculate, **spec_kw)
    common = dict(
        batch_slots=args.slots, max_len=args.max_len, seed=args.seed,
        unified=args.unified, kv_block_size=args.kv_block_size,
        num_blocks=args.num_blocks, prefix_cache=args.prefix_cache,
        speculate=speculate,
        # the f32 default maps to None: the engine's plain (scale-less) path
        kv_dtype=None if args.kv_dtype == "f32" else args.kv_dtype,
        weight_dtype=None if args.weight_dtype == "f32" else args.weight_dtype,
    )
    if mode == "single":
        target = ServeEngine(model, params, device=devices[0], **common)
        desc = "single-device engine"
    else:
        if admission_on:
            common["admission"] = AdmissionPolicy(max_queue=args.max_queue)
        if named is not None:
            target = ServeCluster(
                models={n: (m, p) for n, (_, m, p) in named.items()},
                mode=Mode.parse(mode), devices=devices, **common,
            )
            plan = target.replica_plan()
            if plan is not None:
                print("placement: " + "  ".join(
                    f"{n}->replicas{ix}" for n, ix in plan.items()
                ))
        else:
            target = ServeCluster(model, params, mode=Mode.parse(mode), devices=devices,
                                  **common)
        desc = f"{target!r}"

    # production serving builds once, then serves: every dispatch variant —
    # including the fused top-k/top-p sampler variants if any request will
    # need them — runs BEFORE the timed region unless explicitly disabled
    sampling = args.temperature > 0 or args.top_k > 0 or args.top_p < 1.0
    if not args.no_prewarm:
        target.prewarm(sampling=sampling)

    rng = np.random.default_rng(args.seed)
    names = list(named) if named is not None else [None]
    handles = []
    for i in range(args.requests):
        # heterogeneous streams round-robin across the pinned models; each
        # request samples its prompt from ITS model's vocabulary
        name = names[i % len(names)]
        req_cfg = cfg if name is None else named[name][0]
        plen = int(rng.integers(args.prompt_len // 2 + 1, args.prompt_len + 1))
        req = Request(
            rid=i,
            prompt=rng.integers(0, req_cfg.vocab_size, size=plen).astype(np.int32),
            model=name,
            params=SamplingParams(
                max_new=args.max_new,
                temperature=args.temperature,
                top_k=args.top_k,
                top_p=args.top_p,
                seed=None if args.sample_seed is None else args.sample_seed + i,
                stop=tuple(args.stop),
            ),
            deadline_s=args.deadline_s,
        )
        try:
            handles.append(target.submit(req))
        except AdmissionRejected as rej:
            print(f"req {i} rejected at admission: {rej}")
    if args.stream and handles:
        # the handle iterator drives the engine; every other request makes
        # progress in the same ticks — streaming is a view, not a mode
        print("req 0 stream: ", end="", flush=True)
        for tok in handles[0]:
            print(tok, end=" ", flush=True)
        print(f"[{handles[0].finish_reason}]")
    if controlled:
        # auto: the closed loop — interval slicing, window observation,
        # controller-committed split<->merge switches, measured costs
        stats = target.run_controlled()
        for rep in stats.reconfigures:
            print(f"controller switch: {rep}")
    else:
        stats = target.run()
    # in --stream mode part (or all) of the work was served by the handle-
    # driven pump BEFORE run(), so report totals from the request objects
    # and keep the timed-drain stats for throughput/latency
    done = list(target.finished)
    n_cancelled = sum(r.finish_reason == "cancelled" for r in done)
    arch_label = (
        cfg.name if named is None
        else "+".join(f"{n}:{c.name}" for n, (c, _, _) in named.items())
    )
    if named is not None:
        per_model = {n: 0 for n in named}
        for r in done:
            if r.model in per_model:
                per_model[r.model] += len(r.generated)
        print("per-model tokens: " + "  ".join(f"{n}={t}" for n, t in per_model.items()))
    print(
        f"arch={arch_label} [{desc}] requests={len(done) - n_cancelled} "
        f"(+{n_cancelled} cancelled) "
        f"generated_tokens={sum(len(r.generated) for r in done)}\n"
        f"drain: {stats.total_tokens} decode tokens, {stats.ticks} ticks, "
        f"throughput={stats.tokens_per_sec:,.1f} tok/s  "
        f"TTFT p50={stats.ttft_p50*1e3:.1f}ms p99={stats.ttft_p99*1e3:.1f}ms  "
        f"TPOT p50={stats.tpot_p50*1e3:.2f}ms p99={stats.tpot_p99*1e3:.2f}ms"
    )
    # backpressure / robustness counters: queue high-water mark and KV-pool
    # admission failures come from the engine(s); shed/rejected/rehomed only
    # move when the cluster's admission controller or failure recovery acted
    bp = (
        f"backpressure: queue_peak={getattr(stats, 'queue_peak', 0)} "
        f"alloc_failures={getattr(stats, 'alloc_failures', 0)}"
    )
    if mode != "single":
        # lifetime totals from the admission controller (run()'s stats deltas
        # start at run() entry and would miss this launcher's submit-time
        # rejections)
        adm = target.admission
        bp += (
            f" shed={0 if adm is None else adm.shed}"
            f" rejected={0 if adm is None else adm.rejected}"
            f" rehomed={getattr(stats, 'rehomed', 0)}"
        )
    print(bp)
    # dtype-aware capacity report: actual resident KV bytes (peak over the
    # run), never slots x max_len x f32 — an int8 cache really is ~3-4x
    # lighter per position and this is where that shows up
    print(
        f"kv: dtype={args.kv_dtype} weights={args.weight_dtype} "
        f"resident_bytes={getattr(stats, 'kv_bytes_resident', 0):,}"
    )
    if speculate is not None:
        print(
            f"speculate[{speculate.mode}]: "
            f"accepted {stats.spec_accepted}/{stats.spec_proposed} drafts "
            f"({stats.spec_acceptance:.0%}) over "
            f"{stats.spec_ticks} verify dispatches"
        )
    if args.kv_block_size:
        engines = [target] if mode == "single" else target.engines
        for i, e in enumerate(engines):
            line = f"paged[{i}]: {e.pool.stats()}"
            if e.prefix is not None:
                line += f"\n          {e.prefix.stats()}"
            print(line)
    return target


if __name__ == "__main__":
    main()
