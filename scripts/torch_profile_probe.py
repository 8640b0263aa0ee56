"""Does a torch profile still record device events after the kinds
of work ``chip_smoke.py`` does earlier in its process? Runs
``chip_smoke.merged_profile`` (run_merged's fft2d program over two lanes of
one card) first, then again after each step below, and prints the device
events of every profile:

- nothing in between;
- a profile of 2,000 small kernels on the default stream (as
  ``decode_step_profile``'s), read through ``key_averages``;
- hand-written kernels under a profile (``ops.matmul``, ``ops.softmax``);
- a CUDA-only profile of two threads on streams of their own (as
  ``replica_step_profile``'s);
- ``chip_smoke.time_ms``'s CUDA graph capture and replay, then a profile
  of a graph replay;
- 20 profiles back to back;
- a ``MixedScheduler`` run whose controller threads launch hand-written
  kernels.

Then it profiles the same program eight times more, alternately stopping
the profiler at once and one second after the lanes finish, to see whether
events the profiler drops are ones it had not been handed yet.

    python3 scripts/torch_profile_probe.py
"""

from __future__ import annotations

import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402  (puts the checkout's src/ first on sys.path)

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

ACTS = [ProfilerActivity.CPU, ProfilerActivity.CUDA]


def device_events(prof) -> int:
    return sum(e.device_type == torch.autograd.DeviceType.CUDA for e in prof.events())


def small_kernels(dev):
    x = torch.randn(64, 64, device=dev)
    with profile(activities=ACTS) as prof:
        for _ in range(1000):
            x = (x * 1.0001).tanh()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    return f"{device_events(prof)} device events, {len(rows)} kernel rows"


def hand_written(dev):
    from repro_torch.kernels import ops

    a = torch.randn(256, 512, device=dev, dtype=torch.bfloat16)
    b = torch.randn(512, 256, device=dev, dtype=torch.bfloat16)
    with profile(activities=ACTS) as prof:
        ops.softmax(ops.matmul(a, b))
        torch.cuda.synchronize()
    return f"{device_events(prof)} device events"


def two_threads(dev):
    streams = [torch.cuda.Stream(dev) for _ in range(2)]
    xs = [torch.randn(512, 512, device=dev) for _ in range(2)]

    def body(i):
        with torch.cuda.stream(streams[i]):
            for _ in range(50):
                xs[i] = (xs[i] @ xs[i]).tanh()
            streams[i].synchronize()

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        threads = [threading.Thread(target=body, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    return f"{device_events(prof)} device events"


def graphs(dev):
    x = torch.randn(1024, 1024, device=dev)
    ms = cs.time_ms(lambda: x @ x)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = x @ x
    with profile(activities=ACTS) as prof:
        graph.replay()
        torch.cuda.synchronize()
    del y
    return f"time_ms {ms:.4f} ms; a replay's profile: {device_events(prof)} device events"


def many_profiles(dev):
    x = torch.randn(256, 256, device=dev)
    counts = []
    for _ in range(20):
        with profile(activities=ACTS) as prof:
            x = (x @ x).tanh()
            torch.cuda.synchronize()
        counts.append(device_events(prof))
    return f"device events a profile: {counts}"


def scheduler(dev):
    from repro_torch.core import MixedScheduler, Mode, SpatzformerCluster, VectorTask
    from repro_torch.kernels import ops

    a = torch.randn(256, 512, device=dev, dtype=torch.bfloat16)
    b = torch.randn(512, 256, device=dev, dtype=torch.bfloat16)
    sched = MixedScheduler(SpatzformerCluster(n_pods=2, devices=[dev, dev]))
    rep = sched.run(Mode.SPLIT, [VectorTask(f"v{i}", lambda info: ops.matmul(a, b))
                                 for i in range(4)])
    return f"{len(rep.records)} tasks"


def merged_events(dev, settle_s: float) -> int:
    """``chip_smoke.merged_profile``'s profile of run_merged's fft2d
    program, the host waiting ``settle_s`` seconds after the lanes finish
    and before the profiler stops; its device events."""
    from repro_torch.core import SpatzformerCluster, fft2d_kernel, run_merged
    from repro_torch.dist.sharding import Mesh, NamedSharding, P, device_put

    cl = SpatzformerCluster(n_pods=2, devices=[dev, dev])
    x = cs.sync_fft_input()
    _, _, program = run_merged(fft2d_kernel(rounds=cs.SYNC_ROUNDS), x, cl, repeats=0)
    sh = NamedSharding(Mesh(cl.merged_mesh.lanes, ("fab",)), P("fab", None))
    xd = device_put(torch.from_numpy(x), sh)
    sh.mesh.synchronize()
    with profile(activities=ACTS) as prof:
        program(xd)
        sh.mesh.synchronize()
        time.sleep(settle_s)
    return device_events(prof)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_profile_probe: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    dev = torch.device("cuda")
    _build.load()
    print("merged program, first profile:", cs.merged_profile()["profile_device_events"],
          "device events", flush=True)
    steps = (("nothing", lambda d: ""), ("small kernels", small_kernels),
             ("hand-written kernels", hand_written), ("two threads", two_threads),
             ("CUDA graphs", graphs), ("20 profiles", many_profiles),
             ("scheduler threads", scheduler))
    for name, step in steps:
        said = step(dev)
        n = cs.merged_profile()["profile_device_events"]
        print(f"after {name} ({said}): merged program {n} device events", flush=True)
    for settle_s in (0.0, 1.0) * 4:
        print(f"stopped {settle_s:.0f} s after the lanes finish: merged program "
              f"{merged_events(dev, settle_s)} device events", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
