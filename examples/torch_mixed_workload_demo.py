"""THE PAPER'S EXPERIMENT, live, on the PyTorch port (twin of
``mixed_workload_demo.py``): mixed scalar-vector workloads under split vs
merge mode over the lanes this process is given.

    PYTHONPATH=src python examples/torch_mixed_workload_demo.py          # the card
    # eight lanes of one card: two pods, each a set of streams
    PYTHONPATH=src python examples/torch_mixed_workload_demo.py \\
        --devices cuda:0,cuda:0,cuda:0,cuda:0,cuda:0,cuda:0,cuda:0,cuda:0

NOTE on numbers: the lanes of one card share its SMs, and the scalar task
holds the GIL, so wall-clock split/merge ratios here demonstrate the
MECHANISM (real threads, real dispatch, real barriers), not the paper's
speed-up.
"""

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import (
    Mode,
    MixedScheduler,
    ScalarTask,
    SpatzformerCluster,
    VectorTask,
    coremark,
    fft2d_kernel,
    run_merged,
    run_split_staged,
    switch_mode,
)
from repro_torch.dist import collectives
from repro_torch.dist.sharding import device_put


def make_vector_task(i: int, rows: int, cols: int) -> VectorTask:
    """relu(m @ m.T).sum() of a seeded [rows, cols] matrix sharded by rows
    over the view's batch axes: each lane its row block against the whole
    (all-gathered), the partial sums reduced on the first lane."""

    def fn(info):
        m = np.random.default_rng(i).standard_normal((rows, cols)).astype(np.float32)
        a = device_put(torch.from_numpy(m), info.named(info.batch_spec(2)))
        lanes = a.lanes
        whole = collectives.lane_all_gather(a.shards, lanes, dim=0) if len(lanes) > 1 else a.shards
        parts = []
        for lane, blk, full in zip(lanes, a.shards, whole):
            with lane.use():
                parts.append(torch.relu(blk @ full.T).sum())
        return float(collectives.lane_reduce(parts, lanes))

    return VectorTask(f"gemm{i}", fn)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None, help="one lane (default: the card)")
    ap.add_argument("--devices", default=None,
                    help="comma-separated lanes (a device may repeat)")
    ap.add_argument("--rows", type=int, default=1024)
    ap.add_argument("--cols", type=int, default=512)
    ap.add_argument("--fft", type=int, default=256)
    args = ap.parse_args(argv)
    lanes = [resolve_device(d) for d in (args.devices.split(",") if args.devices
                                         else [args.device])]
    n = len(lanes)
    pods = 2 if n >= 2 and n % 2 == 0 else 1
    cluster = SpatzformerCluster(n_pods=pods, devices=lanes)
    print(cluster)
    sched = MixedScheduler(cluster)

    vts = [make_vector_task(i, args.rows, args.cols) for i in range(6)]
    sts = [ScalarTask("coremark", lambda: coremark(4).checksum)]

    rep_split = sched.run(Mode.SPLIT, vts, sts)
    rep_merge = sched.run(Mode.MERGE, vts, sts)
    print("--- SPLIT ---")
    print(rep_split.summary())
    print("--- MERGE ---")
    print(rep_merge.summary())
    print(f"makespan split/merge = {rep_split.makespan/rep_merge.makespan:.2f}x "
          "(lanes of one card share its SMs)")

    # runtime reconfiguration with live state
    state, swr = switch_mode(cluster, Mode.MERGE, {"w": torch.ones((256, 256))})
    print(f"mode switch: {swr.from_desc}->{swr.to_desc} in {swr.seconds*1e3:.2f} ms")

    out = {"split": {r.name: r.result for r in rep_split.records},
           "merge": {r.name: r.result for r in rep_merge.records}}
    if pods == 2:
        # the sync-bound two-phase kernel, merged vs split-staged
        rng = np.random.default_rng(0)
        x = (rng.standard_normal((args.fft, args.fft))
             + 1j * rng.standard_normal((args.fft, args.fft))).astype(np.complex64)
        k = fft2d_kernel(rounds=2)
        y_m, t_m, _ = run_merged(k, x, cluster)
        y_s, t_s = run_split_staged(k, x, cluster)
        same = bool(np.allclose(y_m, y_s, atol=1e-2))
        print(f"staged fft2d: merged {t_m*1e3:.1f}ms vs split {t_s*1e3:.1f}ms "
              f"(results agree: {same})")
        out["fft_agree"] = same
    return out


if __name__ == "__main__":
    main()
