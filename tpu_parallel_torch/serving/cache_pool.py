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
(``extract``, ``stack_prefix``, :func:`gather_block_rows`) return copies
that may be held.

The block table is host-authoritative (``PagedCachePool.block_table``, a
numpy array with ``table_version`` bumped on every change); the engine
mirrors it into a fixed-address device tensor.  Block export / import
(``export_meta``, ``export_blocks``, ``import_stored``,
``block_checksums``) is not in the port yet.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import List, Optional, Sequence

import numpy as np
import torch

from tpu_parallel_torch.models.layers import KVCache, PagedKVCache


def _valid_prefix(pos: torch.Tensor, length: int) -> torch.Tensor:
    """``pos`` with every column at or beyond ``length`` set to -1."""
    cols = torch.arange(pos.shape[-1], device=pos.device)
    return torch.where(cols < length, pos, torch.full_like(pos, -1))


def insert_rows(pool_cache: List[KVCache], fresh_cache: List[KVCache], slot: int) -> None:
    """Write a batch-1 prefill cache into row ``slot`` of the pool, in
    place.  The scalar ``index`` keeps the pool's value: the engine drives
    decode with explicit positions and ``write_index``."""
    for pool, fresh in zip(pool_cache, fresh_cache):
        pool.key_heads[:, slot].copy_(fresh.key_heads[:, 0])
        pool.value_heads[:, slot].copy_(fresh.value_heads[:, 0])
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
        pool.key_heads.index_copy_(1, dst, fresh.key_heads.index_select(1, rows))
        pool.value_heads.index_copy_(1, dst, fresh.value_heads.index_select(1, rows))
        pool.pos.index_copy_(0, dst, fresh.pos.index_select(0, rows))


def extract_rows(pool_cache: List[KVCache], slot: int, n: int = 1) -> List[KVCache]:
    """A copy of ``n`` consecutive rows starting at ``slot``: a batch-``n``
    cache in the model's own layout (the prefix cache's capture path and
    the chunked prefill's read side)."""
    return [
        KVCache.from_heads(c.key_heads[:, slot:slot + n], c.value_heads[:, slot:slot + n],
                           c.pos[slot:slot + n])
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
        pool.key_heads[:, slot].copy_(prefix.key_heads[:, 0])
        pool.value_heads[:, slot].copy_(prefix.value_heads[:, 0])
        pool.pos[slot].copy_(_valid_prefix(prefix.pos[0], length))


def stack_prefix_rows(rows: Sequence[List[KVCache]], length: int) -> List[KVCache]:
    """Stack batch-1 prefix rows into one batch-N cache (new storage; the
    stored rows stay as they are), position tables trimmed to the first
    ``length`` entries: N same-length prefix hits then extend as one
    padded model call."""
    return [
        KVCache.from_heads(
            torch.cat([c.key_heads for c in layer], dim=1),
            torch.cat([c.value_heads for c in layer], dim=1),
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
        c.key_store[:, dst].copy_(c.key_store[:, src])
        c.value_store[:, dst].copy_(c.value_store[:, src])
        c.pos_store[dst].copy_(c.pos_store[src])


def gather_block_rows(pool_cache: List[PagedKVCache], blocks: Sequence[int]) -> List[torch.Tensor]:
    """Copies of physical ``blocks`` out of every layer, block dim first:
    per layer ``key [k, kv_heads, block_tokens, head_dim]``, ``value``
    (the same) and ``pos [k, block_tokens]``, in that order.  A READ op
    (the device half of a block export); the layout is the port's own
    head-major one, not JAX's ``[k, block_tokens, kv_heads, head_dim]``."""
    idx = _block_index(pool_cache, blocks)
    out = []
    for c in pool_cache:
        out.append(c.key_store.index_select(1, idx).transpose(0, 1).contiguous())
        out.append(c.value_store.index_select(1, idx).transpose(0, 1).contiguous())
        out.append(c.pos_store.index_select(0, idx))
    return out


def scatter_block_rows(pool_cache: List[PagedKVCache], rows: Sequence[torch.Tensor],
                       blocks: Sequence[int]) -> None:
    """Write gathered block rows (the :func:`gather_block_rows` layout)
    into physical ``blocks`` in every layer, in place.  Blocks outside
    ``[0, n_blocks)`` are dropped, as JAX's scatter drops them.  Positions
    copy verbatim: rows always land at the LOGICAL index they were
    gathered from."""
    keep = [i for i, b in enumerate(blocks) if 0 <= int(b) < pool_cache[0].n_blocks]
    if not keep:
        return
    idx = _block_index(pool_cache, [blocks[i] for i in keep])
    sel = torch.as_tensor(keep, device=idx.device)
    it = iter(rows)
    for c in pool_cache:
        for store in (c.key_store, c.value_store):
            store.index_copy_(1, idx, next(it).to(idx.device).index_select(0, sel)
                              .transpose(0, 1).to(store.dtype))
        c.pos_store.index_copy_(0, idx, next(it).to(idx.device).index_select(0, sel))


def default_block_fns():
    """(free_block_pos, copy_block, gather_block_rows, scatter_block_rows):
    the in-place block ops above (JAX jits them, the write ops donating
    the pool)."""
    return (free_block_pos, copy_block, gather_block_rows, scatter_block_rows)


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
        (self._free_pos, self._copy_block, self._gather_rows,
         self._scatter_rows) = block_fns
        # bytes of ONE block across every layer's payloads and positions:
        # the capacity denominator behind kv_bytes_per_active_token
        c = self.cache[0]
        per_block = (c.key_store[:, 0].nbytes + c.value_store[:, 0].nbytes
                     + c.pos_store[0].nbytes)
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

    # -- block export / import ---------------------------------------------

    @property
    def export_meta(self):
        raise _not_ported("PagedCachePool.export_meta")

    def export_blocks(self, blocks):
        raise _not_ported("PagedCachePool.export_blocks")

    def import_stored(self, rows, count: int, checksums=None):
        raise _not_ported("PagedCachePool.import_stored")

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


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not in the PyTorch port yet; it comes with the wire format and "
        "disk KV tier (kv_wire / kv_disk), a later slice of the port"
    )
