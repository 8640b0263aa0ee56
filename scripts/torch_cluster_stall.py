"""Repeat ``chip_smoke.py`` phase 12 (d) and show how close a live replica
comes to the watchdog's verdict.

Two replicas of codeqwen1.5-7b (full width, random weights from seed 0) on
one device serve phase 12's traffic while replica 1's controller stalls at
its 12th iteration. Each repeat prints the run's wall, the dead count, the
re-homed count, the watchdog's straggler / dead events (lane, seconds
into the run), each replica's four longest iterations within one of its
runs, cyclic-GC pauses over 50 ms, and every request that did not finish
with its full ``max_new`` tokens.

    python3 scripts/torch_cluster_stall.py --repeats 5 --dead-after 3 --stall 6
    python3 scripts/torch_cluster_stall.py --device cpu --reduced --repeats 1
"""

from __future__ import annotations

import argparse
import gc
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402  (puts the checkout's src/ first on sys.path)

import torch  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.serve import FailurePolicy, ServeCluster  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--dead-after", type=float, default=cs.DEAD_AFTER_S)
    ap.add_argument("--stall", type=float, default=cs.STALL_S)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true", help="the reduced config (CPU checks)")
    args = ap.parse_args()

    t_start = time.perf_counter()
    pauses: list = []
    gc_t0: dict = {}

    def gc_cb(phase, info):
        if phase == "start":
            gc_t0["t"] = time.perf_counter()
        elif "t" in gc_t0 and time.perf_counter() - gc_t0["t"] > 0.05:
            pauses.append((round(time.perf_counter() - t_start, 2), info["generation"],
                           round(time.perf_counter() - gc_t0["t"], 3)))

    gc.callbacks.append(gc_cb)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        from repro_torch.kernels import _build

        _build.load()
    cfg = get_arch("codeqwen1.5-7b")
    cfg = cfg.reduced() if args.reduced else cfg
    model = LM(cfg, device=str(dev))
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.init(gen)
    kw = dict(batch_slots=4, max_len=1024, prefill_budget=64)
    print(f"{cfg.name}, device {dev}, dead_after {args.dead_after} s, stall {args.stall} s",
          flush=True)
    for rep in range(args.repeats):
        stamps: dict = {0: [], 1: []}
        events: list = []
        lock = threading.Lock()
        t_run = [0.0]

        def stall(idx: int) -> None:
            with lock:
                stamps[idx].append(time.perf_counter())
                n = sum(t is not None for t in stamps[idx])
            if idx == 1 and n == 12:
                time.sleep(args.stall)

        cl = ServeCluster(model, params, devices=[dev, dev], **kw, failure=FailurePolicy(
            straggler_after=1.0, dead_after=args.dead_after, poll=0.05, tick_hook=stall))
        for kind in ("straggler", "dead"):
            hook = getattr(cl, f"_on_{kind}")

            def logged(lane, st, _hook=hook, _kind=kind):
                events.append((_kind, lane, round(time.perf_counter() - t_run[0], 3)))
                _hook(lane, st)

            setattr(cl, f"_on_{kind}", logged)
        for i, e in enumerate(cl.engines):  # mark where each run of a replica starts
            def run(*a, _run=e.run, _i=i, **k):
                with lock:
                    stamps[_i].append(None)
                return _run(*a, **k)

            e.run = run
        cl.prewarm(sampling=True)
        reqs = cs.cluster_traffic(cfg)
        for r in reqs:
            cl.submit(r)
        n_pauses = len(pauses)
        t_run[0] = time.perf_counter()
        stats = cl.run()
        wall = time.perf_counter() - t_run[0]
        with lock:
            gaps = {i: sorted(round(b - a, 3) for a, b in zip(s, s[1:]) if a and b)[-4:]
                    for i, s in stamps.items()}
        bad = [(r.rid, r.finish_reason, len(r.generated)) for r in reqs
               if r.finish_reason is None or len(r.generated) != r.params.max_new]
        print(f"repeat {rep}: wall {wall:.2f} s, dead {stats.dead_replicas}, re-homed "
              f"{stats.rehomed}, events {events}, longest iterations {gaps}, gc pauses "
              f"{pauses[n_pauses:]}, unfinished {bad}", flush=True)
        del cl
        gc.collect()
        time.sleep(max(0.0, args.stall - args.dead_after) + 1.0)  # the stalled thread leaves
    return 0


if __name__ == "__main__":
    sys.exit(main())
