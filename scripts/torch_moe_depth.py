#!/usr/bin/env python3
"""How far one bf16 rounding carries through a random MoE stack: phase 2's
64-token pack (``chip_smoke.PACK_SLOTS`` / ``PACK_POS``) through
``LM.packed_step`` with the kernels against the same step with every kernel
on its plain version, on the card, at cut depths of deepseek-v2-lite-16b
(2, 4, 8, 16 and all 27 layers) and of llama4-scout-17b-a16e (1, 2, 4),
full width, bf16, random weights from a seed; for two scales of the
random experts ``w_in`` / ``w_gate`` [E, d, ff]: their input width d (the
port's ``moe_init``) and the expert count E (the JAX package's
``dense_init`` default, its leading axis). Also the kept share of (token, k)
entries of a 332-token ``LM.prefill`` at the model's capacity factor.

    python scripts/torch_moe_depth.py

Prints one line a reading and a JSON line at the end. Needs a CUDA device
(~40 GB of device memory for deepseek-v2-lite).
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
from dataclasses import replace
from pathlib import Path


def main() -> int:
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs

    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import LM
    from repro_torch.models import moe as moe_mod

    if not torch.cuda.is_available():
        print("torch_moe_depth: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)

    def cut(stack, n):
        if isinstance(stack, dict):
            return {k: cut(v, n) for k, v in stack.items()}
        return stack[:n]

    out = []
    for name, depths in (("deepseek-v2-lite-16b", (2, 4, 8, 16, 27)),
                         ("llama4-scout-17b-a16e", (1, 2, 4))):
        full = replace(get_arch(name), n_layers=max(depths))
        model = LM(full)
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        E, d, kd = full.moe.n_routed, full.d_model, full.first_k_dense
        for scale in ("d", "E"):
            if scale == "E":  # the JAX package's fan-in: d**-0.5 -> E**-0.5
                for k in ("w_in", "w_gate"):
                    params["moe_blocks"]["moe"][k].mul_(math.sqrt(d / E))
            for n in depths:
                m = LM(replace(full, n_layers=n))
                p = dict(params, moe_blocks=cut(params["moe_blocks"], n - kd))
                cache = m.init_cache(cs.SLOTS, cs.S_MAX)
                rng = np.random.default_rng(3)
                toks = torch.from_numpy(
                    rng.integers(0, full.vocab_size, 64).astype(np.int32)).to(dev)
                slot = torch.tensor(cs.PACK_SLOTS, dtype=torch.int32, device=dev)
                pos = torch.tensor(cs.PACK_POS, dtype=torch.int32, device=dev)
                live = pos < cs.S_MAX
                with torch.no_grad():
                    a, _ = m.packed_step(p, cache, toks, slot, pos)
                    with cs.plain_kernels():
                        b, _ = m.packed_step(p, cache, toks, slot, pos)
                a, b = a[live].float(), b[live].float()
                row = dict(model=name, scale=scale, layers=n,
                           rel_err=float((a - b).norm() / b.norm()),
                           top1=float((a.argmax(-1) == b.argmax(-1)).float().mean()))
                out.append(row)
                print(f"  {name} [{smi}], experts at fan-in {scale}, {n} layers: the pack "
                      f"through the kernels vs the plain path: relative error "
                      f"{row['rel_err']:.4f}, top-1 {row['top1']:.3f}", flush=True)
                del cache
            seq = np.random.default_rng(2).integers(0, full.vocab_size, 332).astype(np.int32)
            kept = cs.moe_kept(moe_mod)
            with kept, torch.no_grad():
                model.prefill(params, {"tokens": torch.from_numpy(seq[None]).to(dev)}, 332)
            n_, k_, share = kept.read()["other"]
            out.append(dict(model=name, scale=scale, prefill_kept=share))
            print(f"  {name}, experts at fan-in {scale}: a 332-token prefill at capacity factor "
                  f"{full.moe.capacity_factor} keeps {k_}/{n_} entries ({share:.4f})", flush=True)
        del model, params
        torch.cuda.empty_cache()
    print(json.dumps({"device": smi, "readings": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
