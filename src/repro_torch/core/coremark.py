"""CoreMark-analogue scalar workload (paper §III "Mixed scalar-vector").

EEMBC CoreMark exercises three pillars of scalar/control performance:
list processing (pointer chasing), matrix manipulation (small integer
matmul), and a state machine with CRC validation. This module reimplements
those pillars in pure Python — deliberately host-bound, branchy, and
GIL-holding between bytecodes — to model the control/sequential tasks a
freed controller runs in merge mode (telemetry digestion, request admission
control, config state machines, manifest checksums).

The returned checksum makes the work non-elidable and lets tests assert
determinism. A copy of ``repro/core/coremark.py``: checksums equal the JAX
package's for every (iterations, seed).
"""

from __future__ import annotations

import time
from dataclasses import dataclass


def _crc16(data: bytes, crc: int = 0) -> int:
    for byte in data:
        crc ^= byte
        for _ in range(8):
            crc = (crc >> 1) ^ 0xA001 if crc & 1 else crc >> 1
    return crc & 0xFFFF


def _list_pillar(n: int, seed: int) -> int:
    """Linked-list build / find / reverse / sort (pointer-chasing analogue)."""
    vals = [(seed + i * 2654435761) % 1000 for i in range(n)]
    head: list = []
    for v in vals:
        head.append(v)
    # find middle elements repeatedly (sequential scans)
    acc = 0
    for probe in vals[:: max(n // 17, 1)]:
        try:
            acc += head.index(probe)
        except ValueError:  # pragma: no cover
            pass
    head.reverse()
    head.sort()
    return (acc + head[n // 2]) & 0xFFFF


def _matrix_pillar(dim: int, seed: int) -> int:
    """Small integer matrix multiply + transpose, pure Python."""
    a = [[(seed + i * dim + j) % 7 for j in range(dim)] for i in range(dim)]
    b = [[(seed + j * dim + i) % 5 for j in range(dim)] for i in range(dim)]
    c = [[0] * dim for _ in range(dim)]
    for i in range(dim):
        ai = a[i]
        ci = c[i]
        for k in range(dim):
            aik = ai[k]
            bk = b[k]
            for j in range(dim):
                ci[j] += aik * bk[j]
    return sum(c[i][i] for i in range(dim)) & 0xFFFF


_STATES = ("START", "INT", "FLOAT", "EXP", "SCI", "INVALID")


def _state_pillar(n: int, seed: int) -> int:
    """Numeric-format state machine over a synthetic character stream."""
    stream = []
    x = seed or 1
    for _ in range(n):
        x = (x * 1103515245 + 12345) & 0x7FFFFFFF
        stream.append("0123456789.eE+-,"[x % 16])
    state = "START"
    counts = dict.fromkeys(_STATES, 0)
    for ch in stream:
        if ch == ",":
            counts[state] += 1
            state = "START"
        elif ch.isdigit():
            state = {"START": "INT", "FLOAT": "FLOAT", "EXP": "SCI"}.get(state, state)
        elif ch == ".":
            state = "FLOAT" if state in ("START", "INT") else "INVALID"
        elif ch in "eE":
            state = "EXP" if state in ("INT", "FLOAT") else "INVALID"
        elif ch in "+-":
            state = state if state == "EXP" else "INVALID"
    return sum((i + 1) * v for i, v in enumerate(counts.values())) & 0xFFFF


@dataclass
class CoreMarkResult:
    iterations: int
    seconds: float
    checksum: int

    @property
    def iters_per_sec(self) -> float:
        return self.iterations / max(self.seconds, 1e-12)


def coremark(iterations: int = 10, *, list_n: int = 300, mat_dim: int = 12,
             state_n: int = 600, seed: int = 0x3415) -> CoreMarkResult:
    """Run the scalar workload; one iteration ≈ one CoreMark loop."""
    t0 = time.perf_counter()
    crc = 0
    for it in range(iterations):
        s = seed + it
        crc = _crc16(_list_pillar(list_n, s).to_bytes(2, "little"), crc)
        crc = _crc16(_matrix_pillar(mat_dim, s).to_bytes(2, "little"), crc)
        crc = _crc16(_state_pillar(state_n, s).to_bytes(2, "little"), crc)
    return CoreMarkResult(iterations, time.perf_counter() - t0, crc)
