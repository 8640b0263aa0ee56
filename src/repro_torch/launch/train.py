"""Training launcher: real steps on one lane or over a lane mesh
(counterpart of ``repro/launch/train.py``, with its flags and its printed
lines).

Wired here: the ``SpatzformerCluster`` views (``--mode merge``, the
default, trains over every pod's lanes as one (pod, data, model) mesh with
the batch over (pod, data); ``--mode split`` on pod 0's lanes; ``--pods``
that do not divide the lanes fall back to one pod, as in JAX), AdamW over
the train step (``--grad-accum`` microbatches), the async ``Checkpointer``
with ``--resume`` (restored onto the first lane; the step places it), the
``PrefetchLoader`` thread (the scalar task MERGE parks on the freed
controller), and ``Watchdog`` heartbeats.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch codeqwen1.5-7b \
      --reduced --steps 100 --batch 8 --seq 128 --ckpt-dir ck

  # the plain PyTorch path on the CPU, one lane
  ... -m repro_torch.launch.train --arch codeqwen1.5-7b --reduced --device cpu

  # 8 CPU lanes in 2 pods: (pod 2, data 2, model 2), DP 4 x TP 2
  ... --devices cpu,cpu,cpu,cpu,cpu,cpu,cpu,cpu --mode merge --pods 2

  # four lanes of one card: (data 2, model 2)
  ... --devices cuda:0,cuda:0,cuda:0,cuda:0 --pods 1

``--devices`` names one lane an entry (a card may repeat: each entry is a
stream of its own); without it, ``--device`` is the one lane (default: the
current CUDA device). One lane is the single-device path. Over more, the
train step runs over the view (``make_train_step(..., mesh_info=view)``)
and places params and moments itself; tensor parallelism (a ``model`` axis
over 1) takes the dense family without MLA, and any other family raises
``NotImplementedError`` naming ROADMAP Queue 1 item 10. Params are
``LM.init`` of a generator on the first lane's device seeded by ``--seed``.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Optional, Sequence

import torch

from repro_torch import resolve_device
from repro_torch.ckpt import Checkpointer
from repro_torch.configs import TrainConfig, get_arch
from repro_torch.core import SpatzformerCluster
from repro_torch.data import DataConfig, PrefetchLoader, SyntheticCorpus
from repro_torch.dist.sharding import MeshInfo, lanes_for
from repro_torch.ft import Watchdog
from repro_torch.models import LM
from repro_torch.train import adamw_init, make_train_step


def build_mesh_info(mode: str, pods: int, lanes: Sequence) -> Optional[MeshInfo]:
    """JAX's ``build_mesh_info`` over ``lanes``: None for one lane (the
    single-device path), else the cluster's merge view over ``pods`` pods
    (one pod where they do not divide the lanes), or pod 0's view in split
    mode or with one pod."""
    if len(lanes) == 1:
        return None
    cluster = SpatzformerCluster(n_pods=pods if len(lanes) % pods == 0 else 1,
                                 devices=lanes_for(lanes))
    if mode == "merge" and cluster.n_pods > 1:
        return cluster.merge_info()
    return cluster.pod_info(0)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--mode", default="merge", choices=["merge", "split"])
    ap.add_argument("--pods", type=int, default=2)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="the lane to train on (default: the current CUDA device)")
    ap.add_argument("--devices", default=None,
                    help="comma-separated lanes, one an entry (a device may repeat)")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    lanes = [resolve_device(d) for d in (args.devices.split(",") if args.devices
                                         else [args.device])]
    info = build_mesh_info(args.mode, args.pods, lanes)
    dev = lanes[0]
    tcfg = TrainConfig(lr=args.lr, total_steps=args.steps,
                       warmup_steps=max(args.steps // 20, 5), grad_accum=args.grad_accum)
    model = LM(cfg, device=dev)
    step_fn = make_train_step(model, tcfg, mesh_info=info)
    print(f"arch={cfg.name} params={cfg.num_params():,} "
          f"devices={1 if info is None else info.n_devices}")

    # ---- state
    params = model.init(torch.Generator(dev).manual_seed(args.seed))
    opt = adamw_init(params)
    ckpt = Checkpointer(args.ckpt_dir, keep=3)
    start_step = 0
    if args.resume and ckpt.latest_step() is not None:
        (params, opt), start_step = ckpt.restore((params, opt))
        print(f"resumed from step {start_step}")

    # ---- data (the prefetch thread: a scalar task on the freed controller)
    corpus = SyntheticCorpus(DataConfig(cfg.vocab_size, args.seq, args.batch, seed=args.seed))
    loader = PrefetchLoader(corpus, start_step=start_step, device=dev)

    wd = Watchdog(straggler_after=60.0, dead_after=600.0).start()
    wd.register("trainer")

    t0 = time.time()
    tok_per_step = args.batch * args.seq
    losses = []
    try:
        for step in range(start_step, args.steps):
            batch = next(loader)
            params, opt, metrics = step_fn(params, opt, batch)
            wd.beat("trainer", step)
            losses.append(float(metrics["loss"]))
            if (step + 1) % args.log_every == 0 or step == start_step:
                m = {k: float(v) for k, v in metrics.items()}
                rate = tok_per_step * (step + 1 - start_step) / (time.time() - t0)
                print(f"step {step+1:5d} loss={m['loss']:.4f} gnorm={m['grad_norm']:.3f} "
                      f"lr={m['lr']:.2e} tok/s={rate:,.0f}", flush=True)
            if (step + 1) % args.ckpt_every == 0:
                ckpt.save(step + 1, (params, opt))
        ckpt.save(args.steps, (params, opt), blocking=True)
    finally:
        loader.close()
        wd.stop()
    print(f"done in {time.time()-t0:.1f}s; final loss above. ckpts in {args.ckpt_dir}")
    return {"start_step": start_step, "losses": losses}


if __name__ == "__main__":
    main()
