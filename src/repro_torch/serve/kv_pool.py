"""Block-paged KV pool: the host-side allocator behind paged serving (a
copy of ``repro/serve/kv_pool.py``; numpy only).

Dense serving reserves a worst-case ``[S_max, KV, hd]`` cache row per slot;
a slot serving a 40-token request pays for ``S_max`` positions. The paged
engine instead owns ONE device pool shaped ``[L, num_blocks, block_size,
KV, hd]`` and maps each request onto it through a per-request *block
table*: row ``i`` of a request's table names the pool block holding its
positions ``[i*block_size, (i+1)*block_size)``. A request then costs
``ceil(total_positions / block_size)`` blocks — its actual length, rounded
up to one block — and the freed worst-case headroom becomes extra resident
requests (see the ``_paged_capacity`` bench scenario).

This module is the HOST side only: a free list plus per-block reference
counts. Nothing here touches torch — the engine uploads the tables it builds
from these allocations, and the device indirection lives in the
``(block, offset)`` generalization of the ragged-attention descriptors
(``repro_torch.kernels.paged_attention``, ``csrc/paged_attention.cu``).

Refcounts make prefix sharing safe: a block referenced by a live request
AND retained by the radix prefix tree (:mod:`repro_torch.serve.prefix_cache`)
holds one count per referent, and only drops back onto the free list when
the last referent releases it — a cancel mid-stream frees the cancelled
request's counts and nothing else.

The engine allocates a request's WHOLE worst-case table at admission
(``blocks_for(prompt, max_new, max_len)`` blocks, minus any prefix-shared
ones), so decode growth can never fail mid-stream: pool pressure surfaces
exactly once, at admission, where the engine can make the request wait.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def blocks_for(prompt_len: int, max_new: int, max_len: int, block_size: int) -> int:
    """Worst-case block count for one request: positions ``0 ..
    min(prompt_len + max_new, max_len) - 1``, rounded up to whole blocks.
    Admission reserves all of them up front — decode never allocates.

    Block counts are position counts, NOT bytes: what a block weighs in HBM
    depends on the pool leaves' dtypes (an int8 K/V row plus its f32 scale
    is ``head_dim + 4`` bytes per head vs f32's ``4 * head_dim``), so byte
    math lives in dtype-aware accounting (``PoolStats.kv_bytes_resident``,
    fed by the engine's measured per-block bytes) — never in a
    ``slots × f32`` assumption here."""
    total = min(prompt_len + max_new, max_len)
    return -(-total // block_size)


@dataclass
class PoolStats:
    num_blocks: int
    block_size: int
    free_blocks: int
    used_blocks: int
    allocs: int
    alloc_failures: int
    # actual HBM bytes of ONE pool block across every cache leaf (all L
    # layers, K + V payloads + any scale planes), measured from the live
    # pool's dtypes by the engine — 0 when the owner didn't wire it up
    bytes_per_block: int = 0

    @property
    def utilization(self) -> float:
        return self.used_blocks / max(self.num_blocks, 1)

    @property
    def kv_bytes_resident(self) -> int:
        """Dtype-aware resident KV bytes: used blocks × measured block
        weight. An int8 pool reports ~4x fewer bytes for the same block
        count — the number capacity planning should use."""
        return self.used_blocks * self.bytes_per_block


class BlockPool:
    """Free-list allocator with per-block refcounts over ``num_blocks``
    KV blocks of ``block_size`` positions each.

    ``alloc(n)`` hands out ``n`` blocks with refcount 1 (the requesting
    request's reference); ``acquire``/``release`` adjust the count for
    additional referents (the prefix tree, a prefix-matched request). A
    block returns to the free list when its count reaches zero. The
    allocator is deliberately LIFO (``alloc`` pops the most recently freed
    blocks): reusing warm block ids keeps the device-side pool accesses as
    temporally local as the dense engine's slot reuse.
    """

    def __init__(self, num_blocks: int, block_size: int) -> None:
        assert num_blocks > 0 and block_size > 0, (num_blocks, block_size)
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.refcount = np.zeros(self.num_blocks, np.int32)
        self._free: list[int] = list(range(self.num_blocks - 1, -1, -1))
        self.allocs = 0
        self.alloc_failures = 0
        # set by the engine from the live device pool's leaf dtypes (this
        # module never touches torch); 0 until wired
        self.bytes_per_block = 0

    # ------------------------------------------------------------ allocation

    @property
    def free(self) -> int:
        return len(self._free)

    @property
    def used(self) -> int:
        return self.num_blocks - len(self._free)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def alloc(self, n: int) -> list[int]:
        """Pop ``n`` blocks (refcount 1 each). Raises when the pool cannot
        satisfy the request — callers gate on :meth:`can_alloc` (the engine
        makes the request WAIT instead of crashing)."""
        if n > len(self._free):
            self.alloc_failures += 1
            raise RuntimeError(
                f"KV pool exhausted: need {n} blocks, {len(self._free)} free"
            )
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            assert self.refcount[b] == 0, (b, int(self.refcount[b]))
            self.refcount[b] = 1
        self.allocs += n
        return out

    # ------------------------------------------------------------ refcounts

    def acquire(self, block: int) -> None:
        """Add a reference to an already-live block (prefix share)."""
        assert self.refcount[block] > 0, block
        self.refcount[block] += 1

    def release(self, block: int) -> None:
        """Drop one reference; the block frees when the last holder lets go."""
        assert self.refcount[block] > 0, block
        self.refcount[block] -= 1
        if self.refcount[block] == 0:
            self._free.append(block)

    def release_all(self, blocks: list[int]) -> None:
        for b in blocks:
            self.release(b)

    # ----------------------------------------------------------------- misc

    def reset(self) -> None:
        """Drop every reference (engine ``reset()``: slots are empty and the
        prefix tree is being cleared with us)."""
        self.refcount[:] = 0
        self._free = list(range(self.num_blocks - 1, -1, -1))

    def stats(self) -> PoolStats:
        return PoolStats(
            num_blocks=self.num_blocks,
            block_size=self.block_size,
            free_blocks=self.free,
            used_blocks=self.used,
            allocs=self.allocs,
            alloc_failures=self.alloc_failures,
            bytes_per_block=self.bytes_per_block,
        )

    def __repr__(self) -> str:  # debugging aid
        return (
            f"BlockPool(blocks={self.num_blocks}, bs={self.block_size}, "
            f"free={self.free})"
        )
