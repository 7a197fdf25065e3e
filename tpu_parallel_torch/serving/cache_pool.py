"""KV-cache pools for continuous batching: the port of
``tpu_parallel/serving/cache_pool.py``.

Two layouts share this module:

- **Fixed-slot** (:class:`CachePool`, ``kv_block_tokens == 0``): the pool
  is the model's own decode cache (one :class:`KVCache` per layer, from
  ``GPTLM.init_cache``) at batch ``n_slots``: the batch axis IS the slot
  axis.  Requests own slots for their lifetime: admission prefills the
  request (alone, or in a padded batch) and copies the fresh rows into
  the freed slots; retirement returns the slot index to the free list
  (the row is dead weight until the next insert overwrites all of it,
  position table included, whose ``-1`` entries keep unwritten columns
  out of every attention read).
- **Block-paged** (:class:`PagedCachePool` + :class:`BlockAllocator`,
  ``kv_block_tokens > 0``): K/V live in a pool of fixed-size blocks per
  layer (:class:`PagedKVCache`); each slot owns a block-table row mapping
  logical block indices to physical blocks, filled on demand as the
  sequence grows.  Slot count decouples from ``seq_len``, prefix-cache
  hits are refcounted table writes instead of row copies, and the first
  write into a shared block copies that ONE block (copy-on-write).

In-place invariant, the counterpart of the JAX pool's buffer donation:
every WRITE op here (insert / scatter / clear / copy_prefix, the block
helpers) and every engine tick writes INTO the one preallocated set of
per-layer buffers with ``copy_`` / ``index_copy_`` / ``index_put_``.  The
pool is never reallocated or rebound, so its addresses stay fixed and a
captured CUDA graph of a tick keeps writing the live pool.  Read-side ops
(``extract``, ``stack_prefix``, ``PagedCachePool.export_blocks``) return
copies that may be held.

The block table is host-authoritative (``PagedCachePool.block_table``, a
numpy array with ``table_version`` bumped on every change); the engine
mirrors it into a fixed-address device tensor.

Block export / import (``export_meta``, ``export_blocks``,
``import_stored``, ``block_checksums``) exchanges blocks as host numpy
arrays in the JAX package's layout, not the port's: one array per JAX
cache leaf in flax's flatten order, block dim first (scanned configs:
``cached_key [k, n_layers, block_tokens, kv_heads, head_dim]``,
``cached_pos [k, n_layers, block_tokens]``, ``cached_value``; unrolled:
the three per layer, layers in the order their names ``layer_<i>`` sort;
the int8 cache adds ``cached_key_scale`` after ``cached_key`` and
``cached_value_scale`` after ``cached_value``, ``[..., kv_heads, 1]``
fp32).  So checksums, wire frames and disk blobs are byte-identical across
the two packages.  A bf16 leaf travels as its raw bits
(:data:`BFLOAT16_BITS`).
"""

from __future__ import annotations

import dataclasses
import heapq
import zlib
from typing import List, Optional, Sequence

import numpy as np
import torch

from tpu_parallel_torch.models.layers import KVCache, PagedKVCache


# numpy has no bfloat16 type of its own: a bf16 leaf travels as its raw
# bits, uint16 tagged "bfloat16" so the wire header and the disk blobs name
# the dtype as the JAX package writes it (``leaf_dtype_name``)
BFLOAT16_BITS = np.dtype(np.uint16, metadata={"dtype": "bfloat16"})


def leaf_dtype_name(leaf: np.ndarray) -> str:
    """The dtype name a host leaf is exported under: ``"bfloat16"`` for the
    raw bits of a bf16 leaf (:data:`BFLOAT16_BITS`), else numpy's name."""
    tag = (leaf.dtype.metadata or {}).get("dtype")
    return tag if tag is not None else str(leaf.dtype)


class KVIntegrityError(ValueError):
    """Exported KV block bytes failed their checksum — the payload was
    corrupted somewhere between ``export_blocks`` and the import (host
    RAM rot, a truncated spill, a mangled wire transfer).  Serving such
    blocks would be silently wrong attention for EVERY request sharing
    the prefix; callers catch this, count a typed refusal, and fall
    back to the bitwise recompute path."""


def block_checksums(rows, count: int):
    """Per-block CRC32 over exported host rows (the
    :meth:`PagedCachePool.export_blocks` layout: one array per
    block-axis leaf, block dim at axis 0).  Block ``b``'s checksum
    chains every leaf's row bytes in flatten order, so any flipped bit
    in any payload or position table changes it.  Computed at EXPORT
    time (spill / migration capture) and verified at IMPORT time
    (:meth:`PagedCachePool.import_stored`).  Over the same values it
    equals the JAX package's (a bf16 leaf's raw bits are its bytes)."""
    out = []
    for b in range(count):
        crc = 0
        for leaf in rows:
            crc = zlib.crc32(np.ascontiguousarray(leaf[b]).tobytes(), crc)
        out.append(crc)
    return tuple(out)


def _valid_prefix(pos: torch.Tensor, length: int) -> torch.Tensor:
    """``pos`` with every column at or beyond ``length`` set to -1."""
    cols = torch.arange(pos.shape[-1], device=pos.device)
    return torch.where(cols < length, pos, torch.full_like(pos, -1))


def insert_rows(pool_cache: List[KVCache], fresh_cache: List[KVCache], slot: int) -> None:
    """Write a batch-1 prefill cache into row ``slot`` of the pool, in
    place.  The scalar ``index`` keeps the pool's value: the engine drives
    decode with explicit positions and ``write_index``."""
    for pool, fresh in zip(pool_cache, fresh_cache):
        for dst, src in zip(pool.heads(), fresh.heads()):
            dst[:, slot].copy_(src[:, 0])
        pool.pos[slot].copy_(fresh.pos[0])


def scatter_rows(pool_cache: List[KVCache], fresh_cache: List[KVCache],
                 slots: Sequence[int]) -> None:
    """Write the rows of a batch-N prefill cache into pool rows ``slots``
    [N] (host integers), in place with one ``index_copy_`` per buffer.
    Rows whose slot is out of range (the engine passes ``n_slots`` for a
    padded prefill batch's dummy rows) are dropped, as JAX's scatter drops
    them."""
    n_slots = pool_cache[0].batch
    keep = [(i, int(s)) for i, s in enumerate(slots) if 0 <= int(s) < n_slots]
    if not keep:
        return
    device = pool_cache[0].pos_store.device
    rows = torch.tensor([i for i, _ in keep], dtype=torch.long, device=device)
    dst = torch.tensor([s for _, s in keep], dtype=torch.long, device=device)
    for pool, fresh in zip(pool_cache, fresh_cache):
        for to, src in zip(pool.heads(), fresh.heads()):
            to.index_copy_(1, dst, src.index_select(1, rows))
        pool.pos.index_copy_(0, dst, fresh.pos.index_select(0, rows))


def extract_rows(pool_cache: List[KVCache], slot: int, n: int = 1) -> List[KVCache]:
    """A copy of ``n`` consecutive rows starting at ``slot``: a batch-``n``
    cache in the model's own layout (the prefix cache's capture path and
    the chunked prefill's read side)."""
    return [
        KVCache.from_heads([h[:, slot:slot + n] for h in c.heads()], c.pos[slot:slot + n])
        for c in pool_cache
    ]


def clear_rows(pool_cache: List[KVCache], slot: int) -> None:
    """Invalidate pool row ``slot``: every position-table entry to -1, so
    no query attends the row's stale K/V again (the payloads stay, dead
    bytes until overwritten).  Run before a chunked prefill starts writing
    a freed slot incrementally."""
    for c in pool_cache:
        c.pos[slot].fill_(-1)


def copy_prefix_rows(pool_cache: List[KVCache], prefix_cache: List[KVCache], slot: int,
                     length: int) -> None:
    """Copy a stored prefix row into pool row ``slot`` with only its first
    ``length`` positions valid: K/V copy whole, the position table copies
    masked to -1 beyond ``length``.  The whole-row copy also invalidates
    the slot's previous occupant.  Cached K/V is a function of (token,
    position, weights) only, so the copy equals recomputing the prefix."""
    for pool, prefix in zip(pool_cache, prefix_cache):
        for dst, src in zip(pool.heads(), prefix.heads()):
            dst[:, slot].copy_(src[:, 0])
        pool.pos[slot].copy_(_valid_prefix(prefix.pos[0], length))


def stack_prefix_rows(rows: Sequence[List[KVCache]], length: int) -> List[KVCache]:
    """Stack batch-1 prefix rows into one batch-N cache (new storage; the
    stored rows stay as they are), position tables trimmed to the first
    ``length`` entries: N same-length prefix hits then extend as one
    padded model call."""
    return [
        KVCache.from_heads(
            [torch.cat(heads, dim=1) for heads in zip(*(c.heads() for c in layer))],
            _valid_prefix(torch.cat([c.pos for c in layer]), length),
        )
        for layer in zip(*rows)
    ]


def empty_pool(model, n_slots: int) -> List[KVCache]:
    """The pool: the model's decode cache at batch ``n_slots``, K/V zero,
    every position -1 (no slot attends until a prefill lands in it)."""
    return model.init_cache(n_slots)


class CachePool:
    """Host-side slot bookkeeping + the device cache (``self.cache``, a
    per-layer list of :class:`KVCache` that every op updates in place).

    ``acquire()``/``release()`` manage the free list; ``insert()`` /
    ``scatter()`` commit prefilled requests into their slots.
    """

    def __init__(self, model, n_slots: int, row_fns=None):
        if n_slots < 1:
            raise ValueError(f"n_slots={n_slots} < 1")
        self.n_slots = n_slots
        self.cache = empty_pool(model, n_slots)
        self._free: List[int] = list(range(n_slots))
        if row_fns is None:
            row_fns = default_row_fns()
        (self._insert, self._scatter, self._extract, self._clear,
         self._copy_prefix, self._stack_prefix) = row_fns

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def occupancy(self) -> float:
        return 1.0 - len(self._free) / self.n_slots

    def acquire(self) -> Optional[int]:
        """Claim a free slot index (lowest-first, deterministic), or None."""
        if not self._free:
            return None
        return self._free.pop(0)

    def release(self, slot: int) -> None:
        if slot in self._free or not (0 <= slot < self.n_slots):
            raise ValueError(f"bad release of slot {slot}")
        self._free.append(slot)
        self._free.sort()

    def insert(self, fresh_cache, slot: int) -> None:
        """Row-insert a batch-1 prefill cache into ``slot``."""
        self._insert(self.cache, fresh_cache, slot)

    def scatter(self, fresh_cache, slots) -> None:
        """Scatter a batch-N prefill cache's rows into ``slots`` [N]; pass
        ``n_slots`` for dummy rows (dropped, see :func:`scatter_rows`)."""
        self._scatter(self.cache, fresh_cache, slots)

    def extract(self, slot: int):
        """A copy of one slot's row as a batch-1 cache."""
        return self._extract(self.cache, slot)

    def clear(self, slot: int) -> None:
        """Invalidate a slot's position table before incremental writes."""
        self._clear(self.cache, slot)

    def copy_prefix(self, prefix_cache, slot: int, length: int) -> None:
        """Land a stored prefix row (first ``length`` positions valid) in
        ``slot``: the prefix-reuse admission skips recomputing them."""
        self._copy_prefix(self.cache, prefix_cache, slot, length)

    def stack_prefix(self, rows, length: int):
        """Stored prefix rows as one batch-N cache, trimmed to ``length``."""
        return self._stack_prefix(rows, length)

    def assert_slot_aligned(self, slot: int) -> None:
        """Assert the aligned layout: every valid entry of ``slot``'s
        position table holds its own column index (``pos[col] in {-1,
        col}``), so stale columns beyond a slot's frontier stay invisible
        to the ``kp <= qp`` mask.  A debug aid; one device-to-host copy."""
        for layer, c in enumerate(self.cache):
            row = c.pos[slot].cpu()
            cols = torch.arange(row.shape[0], dtype=row.dtype)
            bad = (row != -1) & (row != cols)
            assert not bool(bad.any()), (
                f"slot {slot} position table misaligned in layer {layer} at columns "
                f"{torch.nonzero(bad)[:4, 0].tolist()}: stale columns would enter attention"
            )


def default_row_fns():
    """(insert, scatter, extract, clear, copy_prefix, stack_prefix): the
    in-place row ops above (JAX jits them with the pool donated)."""
    return (insert_rows, scatter_rows, extract_rows, clear_rows, copy_prefix_rows,
            stack_prefix_rows)


# --- block-paged layout ------------------------------------------------------


def _block_index(pool_cache: List[PagedKVCache], blocks) -> torch.Tensor:
    return torch.as_tensor(np.asarray(blocks, np.int64), device=pool_cache[0].pos_store.device)


def free_block_pos(pool_cache: List[PagedKVCache], blocks: Sequence[int]) -> None:
    """Invalidate physical ``blocks``: every position entry to -1, so a
    recycled block's stale positions can never re-enter attention under
    its next owner's table (the paged analog of :func:`clear_rows`).  K/V
    payloads stay as dead bytes until overwritten, as on the fixed-slot
    path."""
    if len(blocks) == 0:
        return
    idx = _block_index(pool_cache, blocks)
    for c in pool_cache:
        c.pos_store.index_fill_(0, idx, -1)


def copy_block(pool_cache: List[PagedKVCache], src: int, dst: int) -> None:
    """Copy physical block ``src`` onto ``dst`` in every layer: the device
    half of copy-on-write (a slot about to write into a SHARED block gets
    its own copy of that ONE block).  Positions copy verbatim: sharing maps
    the same LOGICAL block index into every sharer's table, so the stored
    global positions are already right for the copy."""
    for c in pool_cache:
        for store in c.stores:
            store[:, dst].copy_(store[:, src])
        c.pos_store[dst].copy_(c.pos_store[src])


def default_block_fns():
    """(free_block_pos, copy_block): the in-place block ops above (JAX jits
    them with the pool donated)."""
    return (free_block_pos, copy_block)


class BlockAllocator:
    """Host-side free list + refcounts over the physical block pool.

    The single mutation authority for block ownership: ``alloc`` hands out
    the lowest-numbered free block with refcount 1, ``share`` bumps a live
    block's refcount (prefix-cache entries and every additional slot
    mapping hold one reference each), ``free`` drops one reference and
    returns the block to the free list when the count hits zero.
    Refcounts can never go negative: freeing an unreferenced block raises
    (the double-free guard), as does sharing one.
    """

    def __init__(self, n_blocks: int):
        if n_blocks < 1:
            raise ValueError(f"n_blocks={n_blocks} < 1")
        self.n_blocks = n_blocks
        self._free: List[int] = list(range(n_blocks))
        self._ref = np.zeros(n_blocks, np.int32)

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.n_blocks - len(self._free)

    def refcount(self, block: int) -> int:
        return int(self._ref[block])

    def alloc(self) -> int:
        """Claim the lowest free block (deterministic), refcount 1."""
        if not self._free:
            raise RuntimeError(
                "block pool exhausted — admission control must reserve "
                "blocks before the engine writes (estimated-blocks gate)"
            )
        block = heapq.heappop(self._free)
        self._ref[block] = 1
        return block

    def share(self, block: int) -> None:
        """One more reference to a LIVE block (a slot mapping or a
        prefix-cache entry)."""
        if not (0 <= block < self.n_blocks) or self._ref[block] < 1:
            raise ValueError(
                f"share of unallocated block {block} "
                f"(refcount {self.refcount(block) if 0 <= block < self.n_blocks else 'n/a'})"
            )
        self._ref[block] += 1

    def free(self, block: int) -> bool:
        """Drop one reference; True when the block actually returned to
        the free list (refcount hit zero: the caller must invalidate its
        device positions via :func:`free_block_pos` before reuse)."""
        if not (0 <= block < self.n_blocks) or self._ref[block] < 1:
            raise ValueError(
                f"double free of block {block} (refcount "
                f"{self.refcount(block) if 0 <= block < self.n_blocks else 'n/a'})"
            )
        self._ref[block] -= 1
        if self._ref[block] == 0:
            heapq.heappush(self._free, block)
            return True
        return False

    def check(self) -> None:
        """Invariant audit (tests / debug): refcounts non-negative, the
        free list holds exactly the zero-refcount blocks, no duplicates."""
        assert (self._ref >= 0).all(), "negative refcount"
        free = sorted(self._free)
        assert free == sorted(set(free)), "duplicate free-list entry"
        zero = np.nonzero(self._ref == 0)[0].tolist()
        assert free == zero, f"free list {free} != zero-ref blocks {zero}"
        assert self.in_use + self.n_free == self.n_blocks


class PagedCachePool:
    """Block-paged pool: the device cache (``self.cache``, one
    :class:`PagedKVCache` per layer) + per-slot block tables + host
    bookkeeping (slot free list, :class:`BlockAllocator`, per-slot block
    entitlements for admission accounting).

    ``block_tokens`` and ``n_blocks`` default to the model config's
    ``kv_block_tokens`` / ``kv_pool_blocks``.  The HOST table
    ``self.block_table`` [n_slots, seq_len // block_tokens] is
    authoritative, -1 = unmapped; ``table_version`` moves on every change
    so the engine rewrites its device copy only then.  All table mutation
    goes through this class (allocation in ``ensure_writable``, refcounted
    sharing in ``map_prefix`` / ``snapshot_blocks``, ``release``), so the
    allocator's refcounts can never drift from the tables.
    """

    def __init__(self, model, n_slots: int, block_tokens: Optional[int] = None,
                 n_blocks: Optional[int] = None, block_fns=None):
        cfg = model.config
        bt = cfg.kv_block_tokens if block_tokens is None else int(block_tokens)
        n_blocks = cfg.kv_pool_blocks if n_blocks is None else int(n_blocks)
        if bt < 1:
            raise ValueError(
                f"PagedCachePool needs kv_block_tokens > 0 (got {bt})"
            )
        if cfg.seq_len % bt != 0:
            raise ValueError(f"kv_block_tokens={bt} must divide seq_len={cfg.seq_len}")
        if n_slots < 1:
            raise ValueError(f"n_slots={n_slots} < 1")
        cfg = dataclasses.replace(cfg, kv_block_tokens=bt, kv_pool_blocks=n_blocks)
        self._scanned = bool(cfg.scan_layers)  # the exported leaves' layout
        self.n_slots = n_slots
        self.block_tokens = bt
        self.max_blocks = cfg.seq_len // bt
        self.n_blocks = n_blocks
        self.cache = [PagedKVCache.empty(cfg, model.device) for _ in range(cfg.n_layers)]
        self.allocator = BlockAllocator(n_blocks)
        self.block_table = np.full((n_slots, self.max_blocks), -1, np.int32)
        self.table_version = 0
        self._free_slots: List[int] = list(range(n_slots))
        # blocks each occupied slot is still entitled to allocate
        # (admission reserved them); available = free - outstanding
        self._target_blocks = np.zeros(n_slots, np.int32)
        # cumulative tallies (ServingMetrics delta-syncs these)
        self.cow_copies = 0
        self.shared_block_maps = 0
        if block_fns is None:
            block_fns = default_block_fns()
        self._free_pos, self._copy_block = block_fns
        # bytes of ONE block across every layer's stores (payloads, int8
        # scales) and positions: the capacity denominator behind
        # kv_bytes_per_active_token
        c = self.cache[0]
        per_block = sum(s[:, 0].nbytes for s in c.stores) + c.pos_store[0].nbytes
        self.bytes_per_block = per_block * cfg.n_layers

    # -- slot lifecycle ----------------------------------------------------

    @property
    def n_free(self) -> int:
        return len(self._free_slots)

    @property
    def occupancy(self) -> float:
        return 1.0 - len(self._free_slots) / self.n_slots

    @property
    def blocks_in_use(self) -> int:
        return self.allocator.in_use

    @property
    def blocks_free(self) -> int:
        return self.allocator.n_free

    def acquire(self) -> Optional[int]:
        if not self._free_slots:
            return None
        return self._free_slots.pop(0)

    def release(self, slot: int) -> None:
        """Return ``slot`` to the free list AND drop its block references:
        exclusively-owned blocks go back to the allocator (positions
        invalidated to -1 so the next owner never attends stale entries);
        shared blocks just decrement (prefix-cache entries and co-sharers
        keep them alive)."""
        if slot in self._free_slots or not (0 <= slot < self.n_slots):
            raise ValueError(f"bad release of slot {slot}")
        freed = [int(b) for b in self.block_table[slot] if b >= 0 and self.allocator.free(int(b))]
        self.block_table[slot, :] = -1
        self.table_version += 1
        self._target_blocks[slot] = 0
        self._free_pos(self.cache, freed)
        self._free_slots.append(slot)
        self._free_slots.sort()

    # -- admission accounting ----------------------------------------------

    def blocks_needed(self, total_tokens: int) -> int:
        """Blocks a request of ``total_tokens`` (prompt + budget) needs,
        ignoring prefix sharing (the conservative admission estimate)."""
        return -(-int(total_tokens) // self.block_tokens)

    def outstanding_blocks(self) -> int:
        """Blocks occupied slots are still entitled to allocate (idle slots
        have target 0, so they contribute nothing)."""
        mapped = (self.block_table >= 0).sum(axis=1)
        return int(np.maximum(self._target_blocks - mapped, 0).sum())

    def blocks_available(self) -> int:
        """Free blocks NOT spoken for by in-flight slots' entitlements: the
        admission gate's budget."""
        return self.allocator.n_free - self.outstanding_blocks()

    def begin_slot(self, slot: int, total_tokens: int, cow_reserve: int = 0) -> None:
        """Record the slot's block entitlement at admission (ceil of its
        worst-case token footprint); lazy allocation draws against it.
        ``cow_reserve`` is extra headroom for copy-on-write allocations
        when prefix sharing can land MID-block (buckets not aligned to
        ``block_tokens``): a COW keeps the original alive under its other
        referents AND claims a fresh block."""
        self._target_blocks[slot] = (
            min(self.max_blocks, self.blocks_needed(total_tokens)) + int(cow_reserve)
        )

    # -- the write path ----------------------------------------------------

    def ensure_writable(self, slot: int, start_col: int, end_col: int) -> None:
        """Make logical columns ``[start_col, end_col)`` of ``slot``
        writable: allocate unmapped blocks in range, and COPY-ON-WRITE any
        block in range whose refcount exceeds one (a prefix-cache entry or
        a co-sharing slot still reads the original).  Runs before every
        engine write, so shared blocks are never scribbled on."""
        if end_col <= start_col:
            return
        first = start_col // self.block_tokens
        last = min(self.max_blocks, self.blocks_needed(end_col))
        dirty = False
        for j in range(first, last):
            blk = int(self.block_table[slot, j])
            if blk < 0:
                self.block_table[slot, j] = self.allocator.alloc()
                dirty = True
            elif self.allocator.refcount(blk) > 1:
                new = self.allocator.alloc()
                self._copy_block(self.cache, blk, new)
                self.allocator.free(blk)  # refcount was > 1: stays alive
                self.block_table[slot, j] = new
                self.cow_copies += 1
                dirty = True
        if dirty:
            self.table_version += 1

    # -- prefix sharing ----------------------------------------------------

    def map_prefix(self, slot: int, blocks, length: int) -> None:
        """Land a stored prefix into ``slot`` as TABLE POINTER WRITES: one
        refcount bump per block, zero K/V copies.  A later write into any
        shared block copy-on-writes through :meth:`ensure_writable`.
        Positions need no trimming: entries beyond ``length`` in the tail
        block hold their own column index (the aligned-layout invariant),
        which every query masks out until the slot overwrites them."""
        need = self.blocks_needed(length)
        if len(blocks) < need:
            raise ValueError(f"prefix of {length} tokens needs {need} blocks, got {len(blocks)}")
        for j in range(need):
            blk = int(blocks[j])
            self.allocator.share(blk)
            self.block_table[slot, j] = blk
        self.shared_block_maps += need
        self.table_version += 1

    def snapshot_blocks(self, slot: int, length: int):
        """Freeze the slot's first ``ceil(length / block_tokens)`` blocks
        as a prefix-cache entry: one refcount bump each, NO copies.  The
        owner's next write into a snapshotted block copy-on-writes away
        from it, so the stored prefix is immutable from this moment."""
        need = self.blocks_needed(length)
        blocks = tuple(int(b) for b in self.block_table[slot, :need])
        if any(b < 0 for b in blocks):
            raise ValueError(
                f"slot {slot} has only {int((self.block_table[slot] >= 0).sum())} mapped "
                f"blocks; cannot snapshot {need}"
            )
        for b in blocks:
            self.allocator.share(b)
        return blocks

    def pin_blocks(self, blocks) -> None:
        """Take a temporary reference on a stored prefix entry's blocks so
        the entry can outlive its LRU slot: a same-tick eviction must not
        free blocks a later admission group looked up but has not mapped
        yet.  Pair every pin with one :meth:`free_stored`."""
        for b in blocks:
            self.allocator.share(int(b))

    def free_stored(self, blocks) -> None:
        """Drop a prefix-cache entry's block references (LRU eviction or a
        lost store race); blocks whose refcount hits zero return to the
        free list with their positions invalidated."""
        freed = [int(b) for b in blocks if self.allocator.free(int(b))]
        self._free_pos(self.cache, freed)

    # -- block export / import (host offload tier + cross-replica migration)

    def _leaf_names(self):
        """The JAX cache leaves of one layer, in flax's flatten order (sorted
        names): the int8 cache adds ``cached_key_scale`` and
        ``cached_value_scale``."""
        if self.cache[0].quantized:
            return ("cached_key", "cached_key_scale", "cached_pos", "cached_value",
                    "cached_value_scale")
        return ("cached_key", "cached_pos", "cached_value")

    @property
    def export_meta(self):
        """Shape signature of one exported block: ``(leaf name, per-block
        shape, dtype)`` per JAX cache leaf in flatten order, equal to the
        JAX pool's for the same config (what :meth:`import_stored` callers
        compare before landing foreign payloads: a different model config
        must refuse, not scribble)."""
        c = self.cache[0]
        kv_heads, _, bt = c.key_store.shape[:3]
        leaves = []
        for name in self._leaf_names():
            store = getattr(c, _LEAF_STORES[name])
            shape = (bt,) if name == "cached_pos" else (bt, kv_heads, store.shape[-1])
            if self._scanned:
                shape = (len(self.cache),) + shape
            leaves.append((name, shape, str(store.dtype).removeprefix("torch.")))
        return tuple(leaves) * (1 if self._scanned else len(self.cache))

    def _exchange_layout(self, k: int):
        """Where the exported leaves of ``k`` blocks lie in one flat byte
        buffer: ``(offset, nbytes, dtype, shape)`` per leaf (block dim
        first, flatten order, 16-byte aligned offsets) and the buffer's
        size."""
        layout, off = [], 0
        for name, shape, _ in self.export_meta:
            dtype = getattr(self.cache[0], _LEAF_STORES[name]).dtype
            nbytes = k * int(np.prod(shape)) * dtype.itemsize
            layout.append((off, nbytes, dtype, (k,) + shape))
            off += -(-nbytes // 16) * 16
        return layout, off

    def _exchange_views(self, buf: torch.Tensor, k: int) -> List[torch.Tensor]:
        """Typed views of the flat byte buffer ``buf`` as the exported
        leaves of ``k`` blocks (:meth:`_exchange_layout`)."""
        return [buf[off:off + n].view(dtype).view(shape)
                for off, n, dtype, shape in self._exchange_layout(k)[0]]

    def _layer_order(self) -> List[int]:
        """Layers in the order the exported leaves hold them: the JAX
        package's unrolled leaves sort by name (``layer_10`` before
        ``layer_2``); a scanned leaf stacks every layer in order."""
        n = len(self.cache)
        return list(range(n)) if self._scanned else sorted(range(n), key=lambda i: f"layer_{i}")

    def _leaf_layer_views(self, views: List[torch.Tensor]):
        """``(layer store, leaf view)`` pairs: each layer's slice of each
        exported leaf (``[k, block_tokens, kv_heads, width]``, positions
        ``[k, block_tokens]``) beside the pool store it mirrors."""
        names = self._leaf_names()
        pairs = []
        for j, layer in enumerate(self._layer_order()):
            c = self.cache[layer]
            if self._scanned:
                leaf_views = [v[:, layer] for v in views]
            else:
                leaf_views = views[len(names) * j:len(names) * (j + 1)]
            pairs += [(getattr(c, _LEAF_STORES[name]), view)
                      for name, view in zip(names, leaf_views)]
        return pairs

    def export_blocks(self, blocks):
        """Copy physical ``blocks``' K/V and positions to HOST memory in the
        JAX package's exported layout: per chunk of at most ``max_blocks``
        blocks, one gather per payload and layer into a device staging
        buffer laid out as the export, then ONE device-to-host copy through
        a pinned buffer.  Returns one numpy array per leaf (flatten order,
        block dim at axis 0, length ``len(blocks)``; bf16 leaves as
        :data:`BFLOAT16_BITS`) — the exchange payload the host offload tier
        spills and migration ships.  A read op: the blocks stay live under
        their references (refcounted immutability: any sharer's write
        copies away first), and the gathers are stream-ordered after any
        tick still writing the pool."""
        if not blocks:
            return []
        n = len(blocks)
        dev = self.cache[0].pos_store.device
        cuda = dev.type == "cuda"
        out = []
        for start in range(0, n, self.max_blocks):
            chunk = [int(b) for b in blocks[start:start + self.max_blocks]]
            k = len(chunk)
            idx = torch.as_tensor(chunk, dtype=torch.long, device=dev)
            staging = torch.empty(self._exchange_layout(k)[1], dtype=torch.uint8, device=dev)
            views = self._exchange_views(staging, k)
            for store, view in self._leaf_layer_views(views):
                if view.dim() == 2:  # positions: [k, block_tokens]
                    view.copy_(store.index_select(0, idx))
                else:
                    view.copy_(store.index_select(1, idx).permute(1, 2, 0, 3))
            host = staging
            if cuda:
                host = torch.empty(staging.shape, dtype=torch.uint8, pin_memory=True)
                host.copy_(staging, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
                done.synchronize()  # host-sync: offload/migration cold path, one per chunk
            for i, view in enumerate(self._exchange_views(host, k)):
                if start == 0:
                    out.append(np.empty((n,) + tuple(view.shape[1:]), _numpy_dtype(view.dtype)))
                out[i][start:start + k] = _host_numpy(view)
        return out

    def _write_blocks(self, rows, blocks) -> None:
        """Land host block rows (the :meth:`export_blocks` layout) in
        physical ``blocks``, in place: the rows packed into one pinned
        buffer, ONE host-to-device copy, then one ``index_copy_`` per
        payload and layer into the pool.  The pool keeps its addresses
        (the captured ticks read it), positions included, so a restored
        block reads its true positions.  The pinned buffer comes from
        PyTorch's caching host allocator, which reuses it only after the
        asynchronous copy has run."""
        k = len(blocks)
        meta = self.export_meta
        if len(rows) != len(meta):
            raise ValueError(f"{len(rows)} leaves for an export of {len(meta)}")
        dev = self.cache[0].pos_store.device
        cuda = dev.type == "cuda"
        host = torch.empty(self._exchange_layout(k)[1], dtype=torch.uint8, pin_memory=cuda)
        for view, row, (name, shape, _) in zip(self._exchange_views(host, k), rows, meta):
            row = np.asarray(row)
            if row.shape[1:] != shape or row.shape[0] < k or row.dtype.itemsize != view.element_size():
                raise ValueError(f"leaf {name} of shape {row.shape} / {row.dtype} does not fit "
                                 f"{k} blocks of {shape}")
            _host_numpy(view)[...] = row[:k].view(_numpy_dtype(view.dtype))
        staging = host.to(dev, non_blocking=True) if cuda else host
        idx = torch.as_tensor([int(b) for b in blocks], dtype=torch.long, device=dev)
        for store, view in self._leaf_layer_views(self._exchange_views(staging, k)):
            if view.dim() == 2:  # positions
                store.index_copy_(0, idx, view)
            else:
                store.index_copy_(1, idx, view.permute(2, 0, 1, 3))

    def import_stored(self, rows, count: int, checksums=None):
        """Allocate ``count`` fresh blocks — each with refcount 1, the
        STORE's reference, exactly like :meth:`snapshot_blocks`'s bumps —
        and land exported host rows in them (:meth:`_write_blocks`).
        Returns the block-id tuple, or None when fewer than ``count``
        blocks are available beyond in-flight slots' entitlements (the
        caller counts a typed restore/migration fallback instead of
        stealing blocks admission already promised).

        ``checksums`` (per-block CRC32s recorded at export time,
        :func:`block_checksums`) are verified BEFORE any allocation or
        device write: a mismatch raises :class:`KVIntegrityError` —
        never lands unverified bytes — and the caller counts a typed
        ``restore_failure``/``integrity`` refusal and recomputes.  The
        imported entry participates in normal sharing from here:
        ``map_prefix`` bumps it per hit, ``free_stored`` releases it."""
        if count < 1:
            return ()
        if checksums is not None:
            got = block_checksums(rows, count)
            want = tuple(int(c) for c in checksums[:count])
            if len(want) < count or got != want:
                bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w] or list(
                    range(len(want), count))
                raise KVIntegrityError(
                    f"KV import refused: block(s) {bad} of {count} fail their export "
                    "checksum — corrupted bytes must recompute, never serve"
                )
        if self.blocks_available() < count:
            return None
        blocks = tuple(self.allocator.alloc() for _ in range(count))
        self._write_blocks(rows, blocks)
        return blocks

    # -- invariants --------------------------------------------------------

    def assert_slot_aligned(self, slot: int) -> None:
        """The paged form of :meth:`CachePool.assert_slot_aligned`: gathered
        through the slot's table, every valid LOGICAL position entry stores
        exactly its own column (``pos[c] in {-1, c}``)."""
        tbl = self.block_table[slot]
        mapped = np.repeat(tbl >= 0, self.block_tokens)
        cols = np.arange(mapped.shape[0])
        for layer, c in enumerate(self.cache):
            pages = c.pos.cpu().numpy()[np.maximum(tbl, 0)].reshape(-1)
            row = np.where(mapped, pages, -1)
            bad = (row != -1) & (row != cols)
            assert not bad.any(), (
                f"slot {slot} paged position table misaligned in layer {layer} at columns "
                f"{np.nonzero(bad)[0][:4].tolist()}: stale columns would enter attention"
            )


# JAX cache leaf -> the PagedKVCache store that holds it
_LEAF_STORES = {
    "cached_key": "key_store", "cached_key_scale": "key_scale_store",
    "cached_pos": "pos_store", "cached_value": "value_store",
    "cached_value_scale": "value_scale_store",
}


def _numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype a host leaf of ``dtype`` is held in (bf16: its raw
    bits, :data:`BFLOAT16_BITS`)."""
    if dtype == torch.bfloat16:
        return BFLOAT16_BITS
    return torch.empty((), dtype=dtype).numpy().dtype


def _host_numpy(t: torch.Tensor) -> np.ndarray:
    """A numpy view of a CPU tensor, a bf16 one through its raw bits."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BFLOAT16_BITS)
    return t.numpy()
