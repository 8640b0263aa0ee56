"""Operational modes of the reconfigurable cluster (paper §II).

* ``SPLIT``  — the fabric is partitioned on the ``pod`` axis into independent
  sub-meshes ("vector units"), each driven by its own controller thread
  ("scalar core"). Two vectorizable workloads proceed concurrently.
* ``MERGE``  — one controller drives the fused fabric (the ``pod`` axis folds
  into the data axes: doubled effective vector length); the freed controller
  threads execute scalar/control tasks that overlap with device compute.

The mode is a runtime property (paper: "the operational mode can also change
at runtime").

The same two modes drive the serving cluster (:mod:`repro_torch.serve.cluster`):
SPLIT is one independent engine replica per device entry behind a
join-shortest-queue router (the router is the scalar control core), MERGE is
one engine over the fabric (the fused vector fabric), and
``ServeCluster.reconfigure`` is the runtime switch whose measured cost plays
the paper's CSR-write number. A copy of ``repro/core/modes.py``.
"""

from __future__ import annotations

import enum


class Mode(str, enum.Enum):
    SPLIT = "split"
    MERGE = "merge"

    @classmethod
    def parse(cls, value: "Mode | str") -> "Mode":
        """Accepts a ``Mode`` or its string value (CLI flags, configs)."""
        if isinstance(value, Mode):
            return value
        return cls(str(value).lower())

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return self.value
