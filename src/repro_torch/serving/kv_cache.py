"""Paged KV-cache block manager (vLLM-style, TPU-native layout).

The pool is ``(num_blocks, block_size, n_kv, head_dim)`` per layer (the
layout the Pallas paged-attention kernel consumes).  The manager hands out
physical block ids; sequences own ordered block lists (their block table).

Blocks are **ref-counted** so the prefix cache (``prefix_cache.py``) can
share immutable shared-prefix blocks across sequences, copy-on-write
style.  A block is in exactly one of three states:

  * FREE    — on the free list;
  * ACTIVE  — referenced by >= 1 sequence block tables (``_ref[b] >= 1``);
  * CACHED  — zero references but retained by the prefix cache (parked;
              its KV is still valid and can be re-acquired or reclaimed).

Invariants (property-tested in tests/test_kv_cache_properties.py):
  * free + active + cached == num_blocks;
  * a block's refcount equals the number of sequence tables containing it;
  * a block referenced by many sequences is written by at most one —
    writers must call :meth:`copy_on_write` first;
  * freeing every sequence and reclaiming every cached block returns the
    manager to all-free.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple


class NoFreeBlocks(Exception):
    pass


class BlockManager:
    def __init__(self, num_blocks: int, block_size: int):
        assert num_blocks > 0 and block_size > 0
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self._owned: Dict[int, List[int]] = {}
        self._ref: Dict[int, int] = {}        # block -> #tables referencing it
        self._cacheable: Set[int] = set()     # registered with the prefix cache
        self._parked: Set[int] = set()        # CACHED: zero-ref, retained

    # ------------------------------------------------------------------ state
    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return self.num_blocks - len(self._free)

    @property
    def cached_blocks(self) -> int:
        return len(self._parked)

    @property
    def hard_used_blocks(self) -> int:
        """Blocks that cannot be reclaimed without hurting a sequence:
        used minus zero-ref parked cache blocks (admission watermarks
        count only these)."""
        return self.used_blocks - len(self._parked)

    @property
    def active_blocks(self) -> int:
        return len(self._ref)

    @property
    def utilization(self) -> float:
        return self.used_blocks / self.num_blocks

    def ref_count(self, block: int) -> int:
        return self._ref.get(block, 0)

    def is_shared(self, block: int) -> bool:
        """True if writing this block would corrupt another reader: either
        multiple tables reference it, or it backs a prefix-cache entry."""
        return self._ref.get(block, 0) > 1 or block in self._cacheable

    def blocks_needed(self, num_tokens: int) -> int:
        return -(-num_tokens // self.block_size)

    def can_allocate(self, seq_id: int, num_tokens: int) -> bool:
        have = len(self._owned.get(seq_id, ()))
        need = self.blocks_needed(num_tokens) - have
        return need <= len(self._free)

    # ------------------------------------------------------------- refcounting
    def ref_acquire(self, block: int):
        """Take a reference: CACHED -> ACTIVE, or bump an ACTIVE block."""
        if block in self._parked:
            self._parked.discard(block)
            self._ref[block] = 1
        elif block in self._ref:
            self._ref[block] += 1
        else:
            raise KeyError(f"block {block} is free; cannot acquire")

    def ref_release(self, block: int) -> bool:
        """Drop a reference.  At zero the block parks (if cache-registered)
        or returns to the free list.  Returns True iff it parked."""
        n = self._ref.get(block)
        if n is None:
            raise KeyError(f"block {block} has no references")
        if n > 1:
            self._ref[block] = n - 1
            return False
        del self._ref[block]
        if block in self._cacheable:
            self._parked.add(block)
            return True
        self._free.append(block)
        return False

    # ------------------------------------------------------- cache registration
    def mark_cacheable(self, block: int):
        """Prefix cache registers a (full, immutable) block it indexes."""
        assert block in self._ref or block in self._parked
        self._cacheable.add(block)

    def reclaim(self, block: int):
        """Prefix-cache eviction: CACHED -> FREE.  Only zero-ref blocks."""
        assert block in self._parked, f"block {block} not evictable"
        self._parked.discard(block)
        self._cacheable.discard(block)
        self._free.append(block)

    def unmark_cacheable(self, block: int):
        """Cache retraction: the index entry backed by this block was
        dropped, so it must free — not park — when its references
        release.  An already-parked block is reclaimed immediately."""
        self._cacheable.discard(block)
        if block in self._parked:
            self._parked.discard(block)
            self._free.append(block)

    # ------------------------------------------------------------- operations
    def allocate(self, seq_id: int, num_tokens: int) -> List[int]:
        """Grow seq's block list to cover num_tokens; returns full table.
        Fresh blocks start with refcount 1 (owned solely by this seq)."""
        table = self._owned.setdefault(seq_id, [])
        need = self.blocks_needed(num_tokens) - len(table)
        if need > len(self._free):
            raise NoFreeBlocks(
                f"need {need} blocks, have {len(self._free)} free")
        for _ in range(max(need, 0)):
            b = self._free.pop()
            self._ref[b] = 1
            table.append(b)
        return table

    def allocate_shared(self, seq_id: int, shared: List[int],
                        num_tokens: int) -> List[int]:
        """Start a sequence table with ``shared`` prefix blocks (references
        already acquired by the caller, e.g. ``PrefixCache.match``), then
        allocate fresh private blocks out to ``num_tokens``."""
        assert seq_id not in self._owned, "allocate_shared seeds a new table"
        self._owned[seq_id] = list(shared)
        return self.allocate(seq_id, num_tokens)

    def copy_on_write(self, seq_id: int, block_idx: int) -> Optional[Tuple[int, int]]:
        """Make table[block_idx] privately writable.  If the block is shared
        (other readers, or it backs a cache entry), swap in a fresh block and
        return ``(src, dst)`` so the caller can copy the KV data; returns
        None when the block was already private."""
        table = self._owned[seq_id]
        old = table[block_idx]
        if not self.is_shared(old):
            return None
        if not self._free:
            raise NoFreeBlocks("copy-on-write needs a free block")
        new = self._free.pop()
        self._ref[new] = 1
        table[block_idx] = new
        self.ref_release(old)
        return old, new

    def free(self, seq_id: int) -> List[int]:
        """Release the sequence's references.  Returns the blocks that went
        back to the free list (shared/cached blocks merely lose a ref)."""
        blocks = self._owned.pop(seq_id, [])
        freed = []
        for b in reversed(blocks):
            n_free = len(self._free)
            self.ref_release(b)
            if len(self._free) > n_free:
                freed.append(b)
        return freed

    def block_table(self, seq_id: int) -> List[int]:
        return list(self._owned.get(seq_id, ()))

    def owned_seqs(self) -> List[int]:
        return list(self._owned)
