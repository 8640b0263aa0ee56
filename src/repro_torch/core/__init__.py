"""The split/merge fabric's host-side pieces ported so far: the operational
modes and the performance model the reconfiguration controller reads. The
mesh-level fabric (``cluster``, ``scheduler``, ``sync``, ``reconfigure``,
``coremark``) waits for tensor-parallel merge (ROADMAP)."""

from repro_torch.core.modes import Mode
from repro_torch.core.perfmodel import H100, HardwareModel

__all__ = ["H100", "HardwareModel", "Mode"]
