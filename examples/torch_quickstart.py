"""Quickstart on the PyTorch port (twin of ``quickstart.py``): build an
assigned architecture, run forward / train-step / decode with a reduced
config, and show the Spatzformer mode API over lanes.

    PYTHONPATH=src python examples/torch_quickstart.py            # the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
    PYTHONPATH=src python examples/torch_quickstart.py --devices cpu,cpu
"""

import argparse
from typing import Optional, Sequence

import torch

from repro_torch import resolve_device
from repro_torch.configs import TrainConfig, get_arch
from repro_torch.core import Mode, SpatzformerCluster, coremark, switch_mode
from repro_torch.models import LM
from repro_torch.train import adamw_init, make_train_step


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None, help="one lane (default: the card)")
    ap.add_argument("--devices", default=None,
                    help="comma-separated lanes for the fabric (a device may repeat)")
    ap.add_argument("--seq", type=int, default=64)
    args = ap.parse_args(argv)
    lanes = args.devices.split(",") if args.devices else [args.device]
    dev = resolve_device(lanes[0])

    # ---- 1. pick an assigned architecture (full config), shrink it
    cfg = get_arch("qwen3-32b")
    print(f"full config: {cfg.name}: {cfg.num_params():,} params")
    cfg = cfg.reduced()
    print(f"reduced: {cfg.num_params():,} params")

    # ---- 2. forward + loss + one optimizer step
    model = LM(cfg, device=dev)
    params = model.init(torch.Generator(dev).manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (4, args.seq),
                         generator=torch.Generator(dev).manual_seed(1), device=dev,
                         dtype=torch.int32)
    with torch.no_grad():
        logits, _ = model.forward(params, {"tokens": toks})
    finite = bool(torch.isfinite(logits).all())
    print("forward:", tuple(logits.shape), "finite:", finite)

    step = make_train_step(model, TrainConfig(lr=1e-3))
    opt = adamw_init(params)
    params, opt, metrics = step(params, opt, {"tokens": toks, "labels": toks})
    loss = float(metrics["loss"])
    print(f"train step: loss={loss:.3f}")

    # ---- 3. prefill + decode three tokens
    with torch.no_grad():
        _, cache = model.prefill(params, {"tokens": toks}, args.seq + 32)
        tok = toks[:, -1:]
        for t in range(args.seq, args.seq + 3):
            cur = torch.full((toks.shape[0],), t, dtype=torch.int32, device=dev)
            lg, cache = model.decode_step(params, cache, {"tokens": tok}, cur)
            tok = lg.argmax(-1).to(torch.int32)
    decoded = tok[:, 0].tolist()
    print("decoded token ids:", decoded)

    # ---- 4. the paper's contribution: runtime-reconfigurable fabric
    cluster = SpatzformerCluster(n_pods=1, devices=lanes)
    print(cluster)
    _, report = switch_mode(cluster, Mode.MERGE, {"params": params})
    print(f"switched to {cluster.mode} in {report.seconds*1e3:.1f} ms")
    cm = coremark(5)
    print(f"scalar (CoreMark-analogue) workload: {cm.iters_per_sec:.1f} iter/s "
          f"checksum={cm.checksum:#06x}")
    return {"finite": finite, "loss": loss, "decoded": decoded, "mode": str(cluster.mode),
            "checksum": cm.checksum}


if __name__ == "__main__":
    main()
