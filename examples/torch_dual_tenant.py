"""SPLIT-mode two-tenant demo on the PyTorch port (twin of
``dual_tenant.py``): two different architectures train concurrently, one
per pod — the paper's "work on different tasks in parallel" use of split
mode — then the SAME split idea at the serving layer: two tenants' request
streams served by a ``ServeCluster`` whose router pins each tenant to its
own engine replica.

    PYTHONPATH=src python examples/torch_dual_tenant.py \\
        --devices cuda:0,cuda:0,cuda:0,cuda:0
    PYTHONPATH=src python examples/torch_dual_tenant.py --devices cpu,cpu
"""

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import TrainConfig, get_arch
from repro_torch.core import Mode, MixedScheduler, SpatzformerCluster, VectorTask
from repro_torch.data import DataConfig, SyntheticCorpus
from repro_torch.models import LM
from repro_torch.serve import Request, SamplingParams, ServeCluster
from repro_torch.train import adamw_init, make_train_step


def make_tenant(arch: str, steps: int = 5, seq: int = 32) -> VectorTask:
    """Train ``arch`` (reduced) for ``steps`` steps on the pod's lanes (data
    parallel over them)."""
    cfg = get_arch(arch).reduced()

    def fn(info):
        dev = info.mesh.lanes[0].device
        model = LM(cfg, device=dev)
        params = model.init(torch.Generator(dev).manual_seed(0))
        opt = adamw_init(params)
        step = make_train_step(model, TrainConfig(lr=1e-3), mesh_info=info)
        corpus = SyntheticCorpus(DataConfig(cfg.vocab_size, seq, 4, seed=1))
        loss = None
        for i in range(steps):
            batch = {k: torch.from_numpy(v).to(dev) for k, v in corpus.batch(i).items()}
            params, opt, m = step(params, opt, batch)
            loss = float(m["loss"])
        return f"{arch}: final loss {loss:.3f}"

    return VectorTask(f"train:{arch}", fn)


def serve_two_tenants(lanes, max_new: int = 8) -> dict:
    """Split-mode serving: one engine replica per lane, each tenant's
    requests pinned to its home replica by the router, and each tenant's
    sampling policy configured ONCE as a cluster-level default: tenantA
    decodes greedily, tenantB samples a seeded nucleus (top-p) stream."""
    cfg = get_arch("codeqwen1.5-7b").reduced()
    model = LM(cfg, device=lanes[0])
    params = model.init(torch.Generator(lanes[0]).manual_seed(0))
    cluster = ServeCluster(
        model, params, mode=Mode.SPLIT, devices=lanes, batch_slots=2, max_len=64,
        tenant_defaults={
            "tenantA": SamplingParams(max_new=max_new),
            "tenantB": SamplingParams(max_new=max_new, temperature=0.9, top_p=0.9, seed=7),
        },
    )
    print(cluster)
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(8):
        reqs.append(Request(
            rid=i,
            prompt=rng.integers(0, cfg.vocab_size, size=int(rng.integers(4, 12))).astype(np.int32),
            tenant="tenantA" if i % 2 == 0 else "tenantB"))
        cluster.submit(reqs[-1])  # tenant default params attach here
    stats = cluster.run()
    homes = cluster.router.tenant_home
    print(f"  served {stats.total_requests} reqs ({stats.tokens_per_sec:,.1f} tok/s), "
          f"tenant homes: {dict(sorted(homes.items()))}, "
          f"per-replica requests: {cluster.router.assigned}")
    print(f"  req 0 [{reqs[0].tenant}] params: greedy -> {reqs[0].generated[:5]}\n"
          f"  req 1 [{reqs[1].tenant}] params: top_p={reqs[1].params.top_p} "
          f"seed={reqs[1].params.seed} -> {reqs[1].generated[:5]}")
    return {"served": stats.total_requests, "homes": dict(homes),
            "generated": {r.rid: list(r.generated) for r in reqs}}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None, help="one lane (default: the card)")
    ap.add_argument("--devices", default=None,
                    help="comma-separated lanes (a device may repeat)")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--max-new", type=int, default=8)
    args = ap.parse_args(argv)
    lanes = [resolve_device(d) for d in (args.devices.split(",") if args.devices
                                         else [args.device])]
    n = len(lanes)
    pods = 2 if n >= 2 and n % 2 == 0 else 1
    # each pod data-parallel over its lanes: the ssm tenant takes no model axis
    cluster = SpatzformerCluster(n_pods=pods, pod_shape=(n // pods, 1), devices=lanes)
    print(cluster)
    sched = MixedScheduler(cluster)
    tenants = [make_tenant("codeqwen1.5-7b", args.steps),
               make_tenant("falcon-mamba-7b", args.steps)]
    rep = sched.run(Mode.SPLIT, tenants, scalar_tasks=None)
    print(rep.summary())
    for r in rep.records:
        print(" ", r.result)
    served = serve_two_tenants(lanes, args.max_new)
    return {"train": {r.name: r.result for r in rep.records}, "serve": served}


if __name__ == "__main__":
    main()
