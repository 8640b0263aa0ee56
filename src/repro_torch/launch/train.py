"""Training launcher: real steps on one lane (counterpart of
``repro/launch/train.py``, with its flags and its printed lines).

Wired here: AdamW over the one-lane train step (``--grad-accum``
microbatches), the async ``Checkpointer`` with ``--resume``, the
``PrefetchLoader`` thread (the scalar task MERGE parks on the freed
controller), and ``Watchdog`` heartbeats.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch codeqwen1.5-7b \
      --reduced --steps 100 --batch 8 --seq 128 --ckpt-dir ck

  # the plain PyTorch path on the CPU
  ... -m repro_torch.launch.train --arch codeqwen1.5-7b --reduced --device cpu

It trains on one lane, ``--device`` (default: the current CUDA device):
the JAX launcher's single-device path (``build_mesh_info`` over one
device). ``--devices`` with more than one lane, ``--mode`` and ``--pods``
ask for a training fabric over lanes and pods, which raises
``NotImplementedError``. Params are ``LM.init`` of a generator on the device
seeded by ``--seed``.
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
from repro_torch.data import DataConfig, PrefetchLoader, SyntheticCorpus
from repro_torch.ft import Watchdog
from repro_torch.models import LM
from repro_torch.train import adamw_init, make_train_step

_MERGED_REFUSED = ("training over {what} (a merged, tensor-parallel training fabric) is "
                   "not ported (ROADMAP Queue 1 item 10); train on one lane with --device")


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
    ap.add_argument("--mode", default=None, choices=["merge", "split"],
                    help="the pod fabric's mode: refused, training runs on one lane")
    ap.add_argument("--pods", type=int, default=None,
                    help="pods of lanes: refused, training runs on one lane")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="the lane to train on (default: the current CUDA device)")
    ap.add_argument("--devices", default=None,
                    help="comma-separated lanes; more than one is refused")
    args = ap.parse_args(argv)

    lanes = args.devices.split(",") if args.devices else [args.device]
    if len(lanes) > 1:
        raise NotImplementedError(_MERGED_REFUSED.format(what=f"{len(lanes)} lanes"))
    if args.mode is not None or args.pods is not None:
        raise NotImplementedError(_MERGED_REFUSED.format(
            what=f"pods (--mode {args.mode}, --pods {args.pods})"))
    dev = resolve_device(lanes[0])

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    tcfg = TrainConfig(lr=args.lr, total_steps=args.steps,
                       warmup_steps=max(args.steps // 20, 5), grad_accum=args.grad_accum)
    model = LM(cfg, device=dev)
    print(f"arch={cfg.name} params={cfg.num_params():,} devices=1")

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

    step_fn = make_train_step(model, tcfg)
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
