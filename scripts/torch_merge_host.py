"""Where the merged engine's decode step spends its host time: codeqwen1.5-7b
at full width (bf16, random weights from a seed, 4 slots x 1024, every slot
decoding), one step of an 8-step chunk on

- the single engine (one stream);
- the merged engine over two lanes of the card (``ServeCluster``'s MERGE:
  two streams, the partial sums ordered by CUDA events);
- the same merged engine with both lanes on the caller's stream (no stream
  switch, no event; a diagnostic, not a serving configuration);

in turns (A, B, C, C, B, A, three rounds), each step's wall time and the
Python calls a step makes (cProfile over 4 steps, its top functions printed
for the first round). Prints the card's name and power limit first.

    python3 scripts/torch_merge_host.py
"""

from __future__ import annotations

import cProfile
import io
import pstats
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402  (puts the checkout's src/ first on sys.path)

import torch  # noqa: E402


def main() -> int:
    setup = cs.card_setup()
    if setup is None:
        return 1
    dev, _ = setup
    from repro_torch.configs import get_arch
    from repro_torch.dist.sharding import serving_mesh_info
    from repro_torch.kernels import _build
    from repro_torch.models import LM
    from repro_torch.serve import ServeEngine

    _build.load()
    cfg = get_arch("codeqwen1.5-7b")
    model = LM(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    kw = dict(batch_slots=4, max_len=1024)
    single = ServeEngine(model, params, **kw)
    merged = ServeEngine(LM(cfg, mesh_info=serving_mesh_info([dev, dev])), params, **kw)
    bare = serving_mesh_info([dev, dev])
    for lane in bare.mesh.lanes:
        lane.stream = None  # both lanes on the caller's stream
    no_streams = ServeEngine(LM(cfg, mesh_info=bare), merged.params, **kw)
    active = torch.ones(4, dtype=torch.int32, device=dev)

    def chunk(eng, n):
        eng._tick_fn(eng._last_tok, eng._cur_len, active, n, None, eng._sp0, 0)
        torch.cuda.synchronize()

    engines = {"single": single, "merged, two lanes": merged,
               "merged, lanes on one stream": no_streams}
    order = list(engines) + list(reversed(engines))
    walls: dict = {k: [] for k in engines}
    calls: dict = {}
    for rnd in range(3):
        for label in order:
            eng = engines[label]
            chunk(eng, 2)
            t0 = time.perf_counter()
            chunk(eng, 8)
            walls[label].append((time.perf_counter() - t0) * 1e3 / 8)
            if label in calls:
                continue
            prof = cProfile.Profile()
            prof.enable()
            chunk(eng, 4)
            prof.disable()
            stats = pstats.Stats(prof)
            calls[label] = stats.total_calls // 4
            out = io.StringIO()
            stats.stream = out
            stats.sort_stats("tottime").print_stats(12)
            print(f"== {label}: {calls[label]} Python calls a step; the top functions "
                  f"(tottime over 4 steps)")
            print("\n".join(out.getvalue().splitlines()[-14:]), flush=True)
    for label, w in walls.items():
        w = sorted(w)
        print(f"{label}: wall {w[len(w) // 2]:.2f} ms a step (median of {len(w)}; min "
              f"{w[0]:.2f}, max {w[-1]:.2f}), {calls[label]} Python calls a step", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
