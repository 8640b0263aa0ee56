"""Radix tree over prompt token blocks: prefix reuse for the paged engine (a
copy of ``repro/serve/prefix_cache.py`` over the port's own ``kv_pool``).

Identical system prompts are the common case at serving scale — every
request of a tenant opens with the same instruction block. The dense
engine prefills (and stores) that prefix once PER REQUEST; with the paged
pool (:mod:`repro_torch.serve.kv_pool`) the K/V of a prompt prefix lives in
pool blocks that any later request can reference through its own block
table, so the tree below lets admission skip both the prefill compute and
the storage for every full block it has seen before.

Structure: a radix tree where each edge consumes exactly ``block_size``
prompt tokens (one KV block). A node owns one pool block — the block
holding the K/V for those positions, computed by whichever request first
ran that prefix — plus one refcount on it, so the block outlives the
request that filled it. ``match`` walks full blocks of a new prompt and
returns the shared block ids; ``insert`` is called once a prompt finishes
prefilling and registers its full prompt blocks.

Sharing is block-aligned copy-on-write: a matched request's table starts
with shared (read-only) block ids and continues with freshly allocated
private ones, and the engine feeds the prompt from the first unmatched
position — divergence inside a block is simply never matched, so the
diverging block is recomputed privately and no mid-block copy ever
happens. Matching is additionally capped at ``len(prompt) - 1`` tokens:
the engine always recomputes at least the final prompt token, whose
logits seed the first sampled token.

Eviction is LRU over leaf nodes whose block has no live referent besides
the tree itself (refcount 1): admission under pool pressure calls
``evict(n)`` before making a request wait. Interior nodes become
evictable as their children go.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.serve.kv_pool import BlockPool


@dataclass
class PrefixStats:
    lookups: int
    hits: int  # lookups that matched >= 1 block
    hit_tokens: int  # prompt tokens skipped via the tree, cumulative
    inserts: int
    nodes: int
    evictions: int


class _Node:
    __slots__ = ("children", "block", "parent", "key", "stamp")

    def __init__(self, parent: Optional["_Node"], key, block: int, stamp: int):
        self.children: dict[tuple, _Node] = {}
        self.parent = parent
        self.key = key  # edge label: tuple of block_size token ids
        self.block = block  # pool block id (-1 on the root)
        self.stamp = stamp  # LRU clock at last touch


class RadixPrefixCache:
    """Block-granular radix tree sharing prompt-prefix KV blocks.

    The tree holds ONE pool reference per node; requests that match a node
    acquire their own reference, so a block is freed only when the tree
    evicts it AND no matched request is still reading it.
    """

    def __init__(self, pool: BlockPool, block_size: int) -> None:
        self.pool = pool
        self.block_size = int(block_size)
        self._root = _Node(None, None, -1, 0)
        self._clock = 0
        self._nodes = 0
        self.lookups = 0
        self.hits = 0
        self.hit_tokens = 0
        self.inserts = 0
        self.evictions = 0

    # ------------------------------------------------------------------ keys

    def _keys(self, prompt: np.ndarray, n_blocks: int):
        bs = self.block_size
        p = np.asarray(prompt)
        for i in range(n_blocks):
            yield tuple(int(t) for t in p[i * bs : (i + 1) * bs])

    # ----------------------------------------------------------------- match

    def match(self, prompt: np.ndarray) -> tuple[list[int], int]:
        """Longest shared prefix of ``prompt`` present in the tree.

        Returns ``(blocks, matched_tokens)``: the shared pool block ids (a
        reference is ACQUIRED on each — the caller owns them exactly like
        freshly allocated blocks and must release them on finish/cancel or
        on an aborted admission) and the token count they cover. Matching
        stops at full blocks and never consumes the final prompt token,
        so the caller always has at least one position to prefill."""
        self.lookups += 1
        bs = self.block_size
        usable = (len(prompt) - 1) // bs  # full blocks, last token excluded
        node = self._root
        blocks: list[int] = []
        self._clock += 1
        for key in self._keys(prompt, usable):
            child = node.children.get(key)
            if child is None:
                break
            child.stamp = self._clock
            self.pool.acquire(child.block)
            blocks.append(child.block)
            node = child
        if blocks:
            self.hits += 1
            self.hit_tokens += len(blocks) * bs
        return blocks, len(blocks) * bs

    # ---------------------------------------------------------------- insert

    def insert(self, prompt: np.ndarray, table: list[int]) -> int:
        """Register a fully prefilled prompt's full blocks.

        ``table`` is the request's block table (shared prefix + private
        blocks, in position order). Each NEW node acquires a tree-owned
        reference on its block; an already-present prefix keeps the
        existing node's block (two requests that raced the same cold
        prefix simply never share — the loser's private copy frees with
        it). Returns the number of nodes added."""
        self.inserts += 1
        bs = self.block_size
        n_full = len(prompt) // bs
        node = self._root
        added = 0
        self._clock += 1
        for i, key in enumerate(self._keys(prompt, n_full)):
            child = node.children.get(key)
            if child is None:
                child = _Node(node, key, table[i], self._clock)
                node.children[key] = child
                self.pool.acquire(table[i])
                self._nodes += 1
                added += 1
            child.stamp = self._clock
            node = child
        return added

    # -------------------------------------------------------------- eviction

    def _evictable(self) -> list[_Node]:
        """Leaf nodes whose block only the tree still references."""
        out: list[_Node] = []
        stack = [self._root]
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            if n is not self._root and not n.children:
                if self.pool.refcount[n.block] == 1:
                    out.append(n)
        return out

    def evict(self, n_blocks: int) -> int:
        """Free up to ``n_blocks`` pool blocks, LRU leaves first. Evicting
        a leaf may expose its parent; the scan repeats until satisfied or
        nothing else is evictable. Returns blocks actually freed."""
        freed = 0
        while freed < n_blocks:
            leaves = self._evictable()
            if not leaves:
                break
            leaves.sort(key=lambda n: n.stamp)
            for leaf in leaves:
                leaf.parent.children.pop(leaf.key)
                self.pool.release(leaf.block)
                self._nodes -= 1
                self.evictions += 1
                freed += 1
                if freed >= n_blocks:
                    break
        return freed

    # ----------------------------------------------------------------- misc

    def clear(self) -> None:
        """Drop the whole tree, releasing every tree-owned reference (so a
        standalone clear returns blocks nobody else holds to the free
        list; engine ``reset()`` additionally resets the pool after us)."""
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            self.pool.release(n.block)
        self._root = _Node(None, None, -1, 0)
        self._nodes = 0
        self._clock = 0

    def stats(self) -> PrefixStats:
        return PrefixStats(
            lookups=self.lookups,
            hits=self.hits,
            hit_tokens=self.hit_tokens,
            inserts=self.inserts,
            nodes=self._nodes,
            evictions=self.evictions,
        )

    def __repr__(self) -> str:
        return f"RadixPrefixCache(bs={self.block_size}, nodes={self._nodes})"
