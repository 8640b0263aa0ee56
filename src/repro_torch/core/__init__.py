"""The paper's contribution: the runtime-reconfigurable split/merge fabric,
over lanes (``dist/sharding.py``: a (device, stream) pair each; one card may
hold several). The cluster's views, the mixed scalar-vector scheduler, the
two-phase sync harness, live-state reconfiguration, the CoreMark-analogue
scalar workload, the operational modes and the performance model the
serving controller reads."""

from repro_torch.core.cluster import SpatzformerCluster
from repro_torch.core.coremark import CoreMarkResult, coremark
from repro_torch.core.modes import Mode
from repro_torch.core.perfmodel import H100, HardwareModel
from repro_torch.core.reconfigure import SwitchReport, reshard, switch_mode
from repro_torch.core.scheduler import (
    MixedScheduler,
    ScalarTask,
    ScheduleReport,
    VectorTask,
)
from repro_torch.core.sync import (
    TwoPhaseKernel,
    fft2d_kernel,
    matmul_chain_kernel,
    run_merged,
    run_split_staged,
)

__all__ = [
    "SpatzformerCluster",
    "Mode",
    "MixedScheduler",
    "VectorTask",
    "ScalarTask",
    "ScheduleReport",
    "SwitchReport",
    "reshard",
    "switch_mode",
    "coremark",
    "CoreMarkResult",
    "TwoPhaseKernel",
    "fft2d_kernel",
    "matmul_chain_kernel",
    "run_merged",
    "run_split_staged",
    "H100",
    "HardwareModel",
]
