"""Slot-based KV-cache pool for continuous batching: the fixed-slot part
of ``tpu_parallel/serving/cache_pool.py``.

The pool is the model's own decode cache (one :class:`KVCache` per layer,
from ``GPTLM.init_cache``) at batch ``n_slots``: the batch axis IS the
slot axis.  Requests own slots for their lifetime: admission prefills
the request (alone, or in a padded batch) and copies the fresh rows into
the freed slots; retirement returns the slot index to the free list (the
row is dead weight until the next insert overwrites all of it, position
table included, whose ``-1`` entries keep unwritten columns out of every
attention read).

In-place invariant, the counterpart of the JAX pool's buffer donation:
every WRITE op here (insert / scatter / clear / copy_prefix) and every
engine decode tick writes INTO the one preallocated set of per-layer
buffers with ``copy_`` / ``index_copy_`` / ``index_put_``.  The pool is
never reallocated or rebound, so its addresses stay fixed and a captured
CUDA graph of the decode tick keeps writing the live pool.  Read-side ops
(``extract``, ``stack_prefix``) return copies that may be held.

Each buffer carries the :class:`KVCache` scratch column at index
``seq_len``; row ops copy it along (it is never read).

The block-paged pool (``BlockAllocator``, ``PagedCachePool``,
``block_checksums``) is not in the port yet.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from tpu_parallel_torch.models.layers import KVCache


def _valid_prefix(pos_buf: torch.Tensor, length: int) -> torch.Tensor:
    """``pos_buf`` with every column at or beyond ``length`` set to -1."""
    cols = torch.arange(pos_buf.shape[-1], device=pos_buf.device)
    return torch.where(cols < length, pos_buf, torch.full_like(pos_buf, -1))


def insert_rows(pool_cache: List[KVCache], fresh_cache: List[KVCache], slot: int) -> None:
    """Write a batch-1 prefill cache into row ``slot`` of the pool, in
    place.  The scalar ``index`` keeps the pool's value: the engine drives
    decode with explicit positions and ``write_index``."""
    for pool, fresh in zip(pool_cache, fresh_cache):
        pool.key_buf[slot].copy_(fresh.key_buf[0])
        pool.value_buf[slot].copy_(fresh.value_buf[0])
        pool.pos_buf[slot].copy_(fresh.pos_buf[0])


def scatter_rows(pool_cache: List[KVCache], fresh_cache: List[KVCache],
                 slots: Sequence[int]) -> None:
    """Write the rows of a batch-N prefill cache into pool rows ``slots``
    [N] (host integers), in place with one ``index_copy_`` per buffer.
    Rows whose slot is out of range (the engine passes ``n_slots`` for a
    padded prefill batch's dummy rows) are dropped, as JAX's scatter drops
    them."""
    n_slots = pool_cache[0].pos_buf.shape[0]
    keep = [(i, int(s)) for i, s in enumerate(slots) if 0 <= int(s) < n_slots]
    if not keep:
        return
    device = pool_cache[0].pos_buf.device
    rows = torch.tensor([i for i, _ in keep], dtype=torch.long, device=device)
    dst = torch.tensor([s for _, s in keep], dtype=torch.long, device=device)
    for pool, fresh in zip(pool_cache, fresh_cache):
        pool.key_buf.index_copy_(0, dst, fresh.key_buf.index_select(0, rows))
        pool.value_buf.index_copy_(0, dst, fresh.value_buf.index_select(0, rows))
        pool.pos_buf.index_copy_(0, dst, fresh.pos_buf.index_select(0, rows))


def extract_rows(pool_cache: List[KVCache], slot: int, n: int = 1) -> List[KVCache]:
    """A copy of ``n`` consecutive rows starting at ``slot``: a batch-``n``
    cache in the model's own layout (the prefix cache's capture path and
    the chunked prefill's read side)."""
    return [
        KVCache(c.key_buf[slot:slot + n].clone(), c.value_buf[slot:slot + n].clone(),
                c.pos_buf[slot:slot + n].clone())
        for c in pool_cache
    ]


def clear_rows(pool_cache: List[KVCache], slot: int) -> None:
    """Invalidate pool row ``slot``: every position-table entry to -1, so
    no query attends the row's stale K/V again (the payloads stay, dead
    bytes until overwritten).  Run before a chunked prefill starts writing
    a freed slot incrementally."""
    for c in pool_cache:
        c.pos_buf[slot].fill_(-1)


def copy_prefix_rows(pool_cache: List[KVCache], prefix_cache: List[KVCache], slot: int,
                     length: int) -> None:
    """Copy a stored prefix row into pool row ``slot`` with only its first
    ``length`` positions valid: K/V copy whole, the position table copies
    masked to -1 beyond ``length``.  The whole-row copy also invalidates
    the slot's previous occupant.  Cached K/V is a function of (token,
    position, weights) only, so the copy equals recomputing the prefix."""
    for pool, prefix in zip(pool_cache, prefix_cache):
        pool.key_buf[slot].copy_(prefix.key_buf[0])
        pool.value_buf[slot].copy_(prefix.value_buf[0])
        pool.pos_buf[slot].copy_(_valid_prefix(prefix.pos_buf[0], length))


def stack_prefix_rows(rows: Sequence[List[KVCache]], length: int) -> List[KVCache]:
    """Stack batch-1 prefix rows into one batch-N cache (a new tensor per
    buffer; the stored rows stay as they are), position tables trimmed to
    the first ``length`` entries: N same-length prefix hits then extend as
    one padded model call."""
    out = []
    for layer in zip(*rows):
        out.append(KVCache(
            torch.cat([c.key_buf for c in layer]),
            torch.cat([c.value_buf for c in layer]),
            _valid_prefix(torch.cat([c.pos_buf for c in layer]), length),
        ))
    return out


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
