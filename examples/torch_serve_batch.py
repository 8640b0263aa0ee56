"""Batched serving on the PyTorch port (twin of ``serve_batch.py``): the
request-lifecycle API over a reduced arch — per-request SamplingParams
(greedy / temperature / nucleus top-p), an incrementally streamed response,
and a mid-stream cancellation. ``--devices`` serves the same requests from
one merged (tensor-parallel) engine over the lanes.

    PYTHONPATH=src python examples/torch_serve_batch.py --arch minicpm3-4b
    PYTHONPATH=src python examples/torch_serve_batch.py --device cpu
    PYTHONPATH=src python examples/torch_serve_batch.py --devices cuda:0,cuda:0
"""

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_arch
from repro_torch.dist.sharding import serving_mesh_info
from repro_torch.models import LM
from repro_torch.serve import Request, SamplingParams, ServeEngine


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="codeqwen1.5-7b")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default=None, help="one lane (default: the card)")
    ap.add_argument("--devices", default=None,
                    help="comma-separated lanes of one merged engine (a device may repeat)")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch).reduced()
    if args.devices:
        info = serving_mesh_info([resolve_device(d) for d in args.devices.split(",")])
        model = LM(cfg, mesh_info=info)
    else:
        model = LM(cfg, device=resolve_device(args.device))
    params = model.init(torch.Generator(model.device).manual_seed(0))
    engine = ServeEngine(model, params, batch_slots=args.slots, max_len=128,
                         device=model.device)
    # every dispatch variant (the fused sampler's too) is built before the
    # first request
    engine.prewarm(sampling=True)

    # three request classes sharing the same fabric, reconfigured per
    # request by SamplingParams
    variants = (
        SamplingParams(max_new=args.max_new),  # greedy
        SamplingParams(max_new=args.max_new, temperature=0.7, seed=1),
        SamplingParams(max_new=args.max_new, temperature=0.9, top_p=0.9, seed=2),
    )
    rng = np.random.default_rng(0)
    handles = [
        engine.submit(Request(
            rid=i,
            prompt=rng.integers(0, cfg.vocab_size, size=int(rng.integers(4, 12))).astype(np.int32),
            params=variants[i % len(variants)]))
        for i in range(args.requests)
    ]

    # stream request 0 token by token (iterating the handle drives the
    # engine; every other request decodes alongside in the same ticks)...
    print("req 0 (greedy) streams: ", end="", flush=True)
    streamed_tokens = []
    for i, tok in enumerate(handles[0]):
        streamed_tokens.append(tok)
        print(tok, end=" ", flush=True)
        if i == 2 and len(handles) > 1:
            handles[-1].cancel()  # ...and abort the last request mid-stream
    print(f"[{handles[0].finish_reason}]")
    print(f"req {handles[-1].rid} cancelled after {len(handles[-1].request.generated)} tokens "
          f"[{handles[-1].finish_reason}]")

    stats = engine.run()  # drain everything still in flight
    streamed = engine.stream_stats  # the handle-driven portion of the work
    done = stats.total_requests + streamed.total_requests
    print(f"arch={cfg.name} slots={args.slots} lanes={len(model.mesh_info.mesh.lanes) if model.merged else 1}")
    print(f"served {done} requests ({streamed.cancelled} cancelled), "
          f"{stats.total_tokens + streamed.total_tokens} decode tokens")
    print(f"drain throughput {stats.tokens_per_sec:,.1f} tok/s  "
          f"TPOT p50={stats.tpot_p50*1e3:.1f}ms p99={stats.tpot_p99*1e3:.1f}ms")
    for r in engine.finished[:3]:
        ttft = ("-" if r.first_token_at is None
                else f"{1e3*(r.first_token_at - r.submitted_at):.0f}ms")
        print(f"  req {r.rid}: finish={r.finish_reason} ttft={ttft} tokens={r.generated[:8]}...")
    return {"served": done, "streamed": streamed_tokens,
            "finish": {h.rid: h.finish_reason for h in handles},
            "generated": {h.rid: list(h.request.generated) for h in handles}}


if __name__ == "__main__":
    main()
