"""Shared-prefix KV reuse: hash-indexed, copy-on-write paged prefix cache.

Multi-agent workloads are dominated by repeated agent system-prompt
prefixes — every Router/Math/Humanities call resends the same preamble
(§2).  This module lets engines skip re-prefilling those tokens: token
sequences are hashed per *full* block with a rolling (radix-style) hash,
so a block's hash commits to the entire token prefix up to and including
that block.  Matching the hash chain of an incoming prompt against the
index yields the longest cached prefix; the engine then prefills only the
suffix and scatters only the new KV.

Block ownership is ref-counted through :class:`BlockManager`
(``kv_cache.py``): a cached block may be referenced by many sequences but
is written by none (cache entries only ever index *full, immutable*
blocks, and writers go through ``copy_on_write``).  When the last
reference drops, the block parks (state CACHED) instead of freeing; under
memory pressure the engine evicts parked blocks in LRU order of last hit.

The same object serves the real paged engine (hashing real token arrays)
and the discrete-event simulator (hashing synthetic per-agent keys via
:meth:`key_chain`), so sim scenarios exercise the identical data
structure and eviction policy.
"""
from __future__ import annotations

import collections
import hashlib
from typing import Dict, List, Sequence

import numpy as np

from repro_torch.serving.kv_cache import BlockManager


class PrefixCacheStats:
    __slots__ = ("hits", "misses", "tokens_saved", "n_evicted", "n_inserted")

    def __init__(self):
        self.hits = 0          # requests that matched >= 1 block
        self.misses = 0        # requests that matched nothing
        self.tokens_saved = 0  # prompt tokens whose prefill was skipped
        self.n_evicted = 0     # blocks reclaimed under memory pressure
        self.n_inserted = 0    # blocks registered into the index

    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0

    def as_dict(self) -> Dict[str, float]:
        return {"hits": self.hits, "misses": self.misses,
                "tokens_saved": self.tokens_saved,
                "n_evicted": self.n_evicted, "n_inserted": self.n_inserted,
                "hit_rate": self.hit_rate()}


class PrefixCache:
    """Hash-chain index ``block_hash -> physical block id`` with LRU order.

    The index is an insertion/use-ordered dict: a hit moves the entry to
    the back, so iteration order is exactly LRU.  Entries whose block is
    actively referenced are never evicted (they cost nothing to keep —
    the block would stay allocated anyway)."""

    def __init__(self, block_size: int):
        assert block_size > 0
        self.block_size = block_size
        self._index: "collections.OrderedDict[int, int]" = collections.OrderedDict()
        self.stats = PrefixCacheStats()

    def __len__(self) -> int:
        return len(self._index)

    # ------------------------------------------------------------------ hashing
    @staticmethod
    def hash_tokens(tokens, block_size: int) -> List[int]:
        """Rolling 64-bit hash per full block of ``tokens``: hash i commits
        to tokens[0 : (i+1)*block_size].  Partial tail blocks get no hash —
        only immutable full blocks are ever shared.  64 bits keep the
        collision probability negligible at engine-lifetime cache sizes
        (~1e-12 at 10k distinct blocks); a collision would silently serve
        another prompt's KV, so 32-bit crc alone is not enough."""
        arr = np.ascontiguousarray(np.asarray(tokens, dtype=np.int64))
        out: List[int] = []
        h = b"\x00" * 8
        for i in range(len(arr) // block_size):
            h = hashlib.blake2b(
                h + arr[i * block_size:(i + 1) * block_size].tobytes(),
                digest_size=8).digest()
            out.append(int.from_bytes(h, "little"))
        return out

    @staticmethod
    def key_chain(key: str, n_blocks: int) -> List[int]:
        """Synthetic hash chain for the simulator: deterministic per
        (cache key, block index), chained like :meth:`hash_tokens` so
        prefix-of relationships are preserved."""
        out: List[int] = []
        h = b"\x00" * 8
        for i in range(n_blocks):
            h = hashlib.blake2b(h + f"{key}|{i}".encode(),
                                digest_size=8).digest()
            out.append(int.from_bytes(h, "little"))
        return out

    # ------------------------------------------------------------------ lookup
    def match(self, hashes: Sequence[int], bm: BlockManager) -> List[int]:
        """Longest cached prefix of the hash chain.  Acquires a reference
        on every returned block (caller owns them — pass to
        ``allocate_shared`` or ``ref_release`` them on abort).

        Does NOT update hit/miss stats: admission can still abort on
        capacity, and a stalled head-of-queue request retries its match
        every engine step — call :meth:`note_admitted` once the request
        is actually admitted."""
        blocks: List[int] = []
        for h in hashes:
            b = self._index.get(h)
            if b is None:
                break
            bm.ref_acquire(b)
            self._index.move_to_end(h)
            blocks.append(b)
        return blocks

    def note_admitted(self, n_matched_blocks: int, had_hashes: bool):
        """Record stats for one admitted request."""
        if n_matched_blocks:
            self.stats.hits += 1
            self.stats.tokens_saved += n_matched_blocks * self.block_size
        elif had_hashes:
            self.stats.misses += 1

    def insert(self, hashes: Sequence[int], table: Sequence[int],
               bm: BlockManager) -> List[tuple]:
        """Register freshly prefilled full blocks: hashes[i] -> table[i].
        Already-indexed hashes are kept (first writer wins; the colliding
        block stays private to its sequence).  Returns the ``(hash,
        block)`` pairs actually inserted, so a caller that indexed blocks
        ahead of KV execution can :meth:`retract` them on preemption."""
        inserted = []
        for h, b in zip(hashes, table):
            if h in self._index:
                continue
            self._index[h] = b
            bm.mark_cacheable(b)
            self.stats.n_inserted += 1
            inserted.append((h, b))
        return inserted

    def retract(self, pairs: Sequence[tuple], bm: BlockManager) -> List[int]:
        """De-index entries whose KV was never written (a request whose
        admission inserted them was preempted before its prefill
        executed).  Returns the blocks dropped from the index; they will
        free — not park — once their references release."""
        dropped = []
        for h, b in pairs:
            if self._index.get(h) != b:
                continue
            del self._index[h]
            bm.unmark_cacheable(b)
            dropped.append(b)
        return dropped

    # ------------------------------------------------------------------ evict
    def evict(self, bm: BlockManager, n_blocks: int) -> int:
        """Reclaim up to ``n_blocks`` zero-ref (parked) blocks, coldest
        first.  Returns how many went back to the free list."""
        freed = 0
        if n_blocks <= 0:
            return 0
        for h in list(self._index):
            if freed >= n_blocks:
                break
            b = self._index[h]
            if bm.ref_count(b) > 0:
                continue            # hot: some sequence still reads it
            del self._index[h]
            bm.reclaim(b)
            freed += 1
        self.stats.n_evicted += freed
        return freed

    def clear(self, bm: BlockManager):
        """Drop every zero-ref entry (e.g. on engine reset)."""
        self.evict(bm, len(self._index))

    # ------------------------------------------------------------------ helpers
    def usable_prefix_blocks(self, prompt_len: int) -> int:
        """How many full blocks of a prompt may be served from cache: at
        least one token must always be prefilled to produce next-token
        logits, so reuse is capped at ``prompt_len - 1`` tokens."""
        if prompt_len <= 1:
            return 0
        return (prompt_len - 1) // self.block_size
