"""End-to-end training on the PyTorch port (twin of ``train_lm.py``): data
pipeline -> train loop -> async checkpointing -> restart, on a real (small)
LM, on one lane or over lanes.

Defaults are the reduced codeqwen (120 steps; the loss drops on the
structured synthetic corpus). ``--preset 100m`` selects a ~100M-param
config for a card.

    PYTHONPATH=src python examples/torch_train_lm.py                 # the card
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu --steps 300 --resume
    # 4 lanes of one card: (data 2, model 2)
    PYTHONPATH=src python examples/torch_train_lm.py --devices cuda:0,cuda:0,cuda:0,cuda:0

``--devices`` trains over one pod of the given lanes (``launch.train``'s
``build_mesh_info`` in merge mode with one pod: data rows by tensor-parallel
lanes); the train step places the state on them.
"""

import argparse
import dataclasses
import os
import tempfile
import time
from typing import Optional, Sequence

import torch

from repro_torch import resolve_device
from repro_torch.ckpt import Checkpointer
from repro_torch.configs import TrainConfig, get_arch
from repro_torch.data import DataConfig, PrefetchLoader, SyntheticCorpus
from repro_torch.launch.train import build_mesh_info
from repro_torch.models import LM
from repro_torch.train import adamw_init, make_train_step


def build_cfg(preset: str):
    base = get_arch("codeqwen1.5-7b")
    if preset == "tiny":
        return base.reduced()
    # ~100M: 12L x 768, the classic small-LM shape
    return dataclasses.replace(base.reduced(), n_layers=12, d_model=768, n_heads=12,
                               n_kv_heads=12, d_head=64, d_ff=3072, vocab_size=32768)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--preset", default="tiny", choices=["tiny", "100m"])
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train_lm"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None, help="one lane (default: the card)")
    ap.add_argument("--devices", default=None,
                    help="comma-separated lanes (a device may repeat), as launch.train's")
    args = ap.parse_args(argv)
    lanes = [resolve_device(d) for d in (args.devices.split(",") if args.devices
                                         else [args.device])]
    info = build_mesh_info("merge", 1, lanes)

    cfg = build_cfg(args.preset)
    model = LM(cfg, device=lanes[0])
    print(f"training {cfg.name} ({cfg.num_params():,} params) for {args.steps} steps "
          f"@ batch={args.batch} seq={args.seq} on {len(lanes)} lane(s)")

    params = model.init(torch.Generator(lanes[0]).manual_seed(0))
    opt = adamw_init(params)
    tcfg = TrainConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 3),
                       total_steps=args.steps)
    step = make_train_step(model, tcfg, mesh_info=info)

    ckpt = Checkpointer(args.ckpt_dir, keep=2)
    start = 0
    if args.resume and ckpt.latest_step() is not None:
        (params, opt), start = ckpt.restore((params, opt))
        print(f"resumed at step {start}")

    corpus = SyntheticCorpus(DataConfig(cfg.vocab_size, args.seq, args.batch, seed=0))
    loader = PrefetchLoader(corpus, start_step=start, device=lanes[0])

    t0 = time.time()
    first_loss = final = None
    try:
        for i in range(start, args.steps):
            params, opt, m = step(params, opt, next(loader))
            final = float(m["loss"])
            if first_loss is None:
                first_loss = final
            if (i + 1) % 10 == 0:
                rate = args.batch * args.seq * (i + 1 - start) / (time.time() - t0)
                print(f"step {i+1:4d} loss={final:.4f} gnorm={float(m['grad_norm']):.2f} "
                      f"tok/s={rate:,.0f}", flush=True)
            if (i + 1) % 40 == 0:
                ckpt.save(i + 1, (params, opt))  # async
        ckpt.save(args.steps, (params, opt), blocking=True)
    finally:
        loader.close()
    if first_loss is not None:
        print(f"loss {first_loss:.3f} -> {final:.3f} "
              f"({'DECREASED' if final < first_loss else 'no progress'}); "
              f"checkpoints in {args.ckpt_dir}")
    return {"start": start, "first_loss": first_loss, "final_loss": final}


if __name__ == "__main__":
    main()
