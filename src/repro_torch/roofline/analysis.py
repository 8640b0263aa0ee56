"""Roofline terms of a cell on the H100 (counterpart of
``repro/roofline/analysis.py``): analytic counts (:mod:`.flops`) over the
card's published peaks.

The JAX module also parses the collectives out of compiled HLO text
(``parse_collectives``); the port has no HLO. Its dry run counts them as
they run instead (``dist/collectives.py::counting``), each as often as eager
runs it, which is what JAX's ``roofline/hlo_loops.py`` rebuilds from a
``while`` body's trip counts.

Hardware constants: NVIDIA's data sheet for the H100 SXM 80GB at its 700 W
limit — 989e12 FLOP/s dense bf16 on the tensor cores, 3.35e12 B/s of HBM3,
and 450e9 B/s of NVLink each way (900 GB/s to the other cards of the host,
all to all), in place of the JAX module's TPU v5e figures (197e12, 819e9,
50e9). A card set below 700 W runs slower under load.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

PEAK_FLOPS = 989e12  # H100 SXM, dense bf16 (data sheet, 700 W)
HBM_BW = 3.35e12  # H100 SXM 80GB HBM3
LINK_BW = 450e9  # NVLink 4, each way per card


@dataclass
class RooflineTerms:
    """All quantities GLOBAL (whole mesh) per step; terms in seconds."""

    name: str
    chips: int
    flops: float  # global FLOPs/step
    hbm_bytes: float  # global HBM traffic bytes/step
    coll_bytes: float  # global bytes crossing chip links /step
    model_flops: float = 0.0  # 6·N·D (dense) or 6·N_active·D (MoE)
    memory_per_device: Optional[float] = None

    @property
    def t_compute(self) -> float:
        return self.flops / (self.chips * PEAK_FLOPS)

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / (self.chips * HBM_BW)

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / (self.chips * LINK_BW)

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        """Roofline step time: the max term (perfect overlap assumption)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def mfu(self) -> float:
        """Model FLOPs utilization at the roofline step time."""
        if self.model_flops and self.step_time > 0:
            return self.model_flops / (self.chips * PEAK_FLOPS * self.step_time)
        return 0.0

    @property
    def usefulness(self) -> float:
        """MODEL_FLOPS / total FLOPs (catches remat/redundancy waste)."""
        return self.model_flops / self.flops if self.flops else 0.0

    def row(self) -> str:
        return (
            f"{self.name:42s} {self.t_compute*1e3:9.2f} {self.t_memory*1e3:9.2f} "
            f"{self.t_collective*1e3:9.2f}  {self.bottleneck:10s} "
            f"{self.usefulness:6.2f} {self.mfu*100:6.1f}%"
        )

    @staticmethod
    def header() -> str:
        return (
            f"{'cell':42s} {'t_comp(ms)':>9s} {'t_mem(ms)':>9s} {'t_coll(ms)':>9s}"
            f"  {'bound':10s} {'useful':>6s} {'MFU':>7s}"
        )
