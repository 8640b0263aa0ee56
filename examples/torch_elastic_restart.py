"""Fault tolerance on the PyTorch port (twin of ``elastic_restart.py``):
train, kill a pod mid-run, shrink onto the survivors' lanes, restore, finish.

    PYTHONPATH=src python examples/torch_elastic_restart.py \\
        --devices cuda:0,cuda:0,cuda:0,cuda:0,cuda:0,cuda:0,cuda:0,cuda:0
    PYTHONPATH=src python examples/torch_elastic_restart.py --devices cpu,cpu,cpu,cpu
"""

import argparse
import tempfile
from typing import Optional, Sequence

import torch

from repro_torch import resolve_device
from repro_torch.ckpt import Checkpointer
from repro_torch.core import SpatzformerCluster
from repro_torch.dist.sharding import device_put, gather, replicated
from repro_torch.ft import run_elastic


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None, help="one lane (default: the card)")
    ap.add_argument("--devices", default=None,
                    help="comma-separated lanes (a device may repeat)")
    args = ap.parse_args(argv)
    lanes = [resolve_device(d) for d in (args.devices.split(",") if args.devices
                                         else [args.device])]
    n = len(lanes)
    pods = 2 if n >= 2 and n % 2 == 0 else 1
    cluster = SpatzformerCluster(n_pods=pods, devices=lanes)
    print(f"starting fabric: {cluster}")

    def make_state(info):
        state = {"w": torch.zeros((64,), device=lanes[0]),
                 "steps": torch.tensor(0, dtype=torch.int32, device=lanes[0])}
        return device_put(state, replicated(info))

    def step_factory(info):
        print(f"  (re)building the step for {info.n_devices} lanes")

        def step(state, batch, _):
            # the new value goes back onto the state's placement: the
            # survivors' view after a restore
            out = {}
            for k, inc in (("w", batch["x"]), ("steps", 1)):
                v = state[k]
                out[k] = device_put(gather(v) + inc, v.sharding)
            return out

        return step

    def batches(i):
        return {"x": torch.full((64,), float(i), device=lanes[0])}

    with tempfile.TemporaryDirectory() as d:
        ckpt = Checkpointer(d, keep=3)
        fail_at = {12: 1} if pods == 2 else {}
        state, report = run_elastic(cluster, make_state, step_factory, batches, ckpt,
                                    total_steps=25, ckpt_every=5, fail_at=fail_at)
    steps = int(gather(state["steps"], "cpu"))
    print(f"finished: steps={report.steps_done} failures={report.failures} "
          f"final_devices={report.final_devices} restarts={report.restarts}")
    print(f"state check: steps counter={steps} (restored step replays from last checkpoint)")
    return {"steps_done": report.steps_done, "failures": report.failures,
            "final_devices": report.final_devices, "restarts": report.restarts,
            "steps": steps, "w": gather(state["w"], "cpu")}


if __name__ == "__main__":
    main()
