"""Packed-sequence dataset: the port of ``tpu_parallel/data/packed.py``
(copied; numpy).  Variable-length documents packed into fixed rows.

The flash kernels mask same-segment attention in-kernel (``segment_ids``
into ``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu``); this supplies the
loader side: a token stream of EOS-terminated documents becomes fixed ``seq_len`` rows
holding several whole documents each, with

- ``segment_ids``: 1, 2, ... per document within the row, 0 on padding —
  attention never crosses documents,
- ``positions``: restarting at 0 per document (correct RoPE / learned
  embeddings per document),
- ``loss_mask``: 0 on padding and on each document's final token (the
  next-token target would cross into the neighbouring document).

Same duck interface as :class:`~tpu_parallel_torch.data.loader.TokenDataset`
(``num_windows`` + ``batch(order)``), so :class:`DataLoader` — including its
holdout split and prefetch — works unchanged.

Packing is deterministic first-fit in stream order (documents longer than
``seq_len`` are split); shuffling happens at the row level in the loader, so
resumed runs replay identical batches.
"""

from __future__ import annotations

import numpy as np

from tpu_parallel_torch.core.state import TextBatch


class PackedDataset:
    """Rows of whole documents packed from an EOS-delimited token stream."""

    # EOS scan block size: bounds the transient bool array on huge memmaps
    _SCAN_BLOCK = 1 << 24

    def __init__(self, tokens, seq_len: int, eos_id: int):
        if isinstance(tokens, str):
            tokens = np.memmap(tokens, dtype=np.uint16, mode="r")
        self.tokens = tokens
        self.seq_len = seq_len
        self.eos_id = eos_id
        n_tokens = len(tokens)

        # document ends (exclusive, INCLUDING the trailing EOS), scanned in
        # blocks so the corpus never materializes in RAM; a final partial
        # document (no trailing EOS) is kept too
        end_blocks = []
        for off in range(0, n_tokens, self._SCAN_BLOCK):
            blk = np.asarray(tokens[off : off + self._SCAN_BLOCK])
            end_blocks.append(np.flatnonzero(blk == eos_id).astype(np.int64) + off + 1)
        ends = (
            np.concatenate(end_blocks) if end_blocks else np.zeros(0, np.int64)
        )
        if len(ends) == 0:
            raise ValueError(
                f"no eos_id={eos_id} found in the {n_tokens}-token stream — "
                "packing needs document boundaries (wrong eos_id for this "
                "corpus/vocab?)"
            )
        if ends[-1] != n_tokens:
            ends = np.append(ends, n_tokens)
        starts = np.concatenate([[0], ends[:-1]])
        keep = ends > starts
        starts, ends = starts[keep], ends[keep]

        # split oversize documents into seq_len chunks — vectorized
        lens = ends - starts
        n_chunks = -(-lens // seq_len)  # ceil
        rep_starts = np.repeat(starts, n_chunks)
        # grouped arange (0..n_chunks[d]-1 per doc) without a Python loop
        grp_first = np.concatenate([[0], np.cumsum(n_chunks)[:-1]])
        within = np.arange(int(n_chunks.sum())) - np.repeat(grp_first, n_chunks)
        chunk_starts = rep_starts + within * seq_len
        chunk_ends = np.minimum(chunk_starts + seq_len, np.repeat(ends, n_chunks))
        self._chunk_starts = chunk_starts
        self._chunk_ends = chunk_ends

        # first-fit in stream order: row r covers the longest chunk run
        # whose total length fits seq_len — O(rows log chunks) via
        # searchsorted over the cumulative chunk lengths.  Deterministic,
        # so row i is stable across runs (resume replay).
        cum = np.concatenate([[0], np.cumsum(chunk_ends - chunk_starts)])
        bounds = [0]
        while bounds[-1] < len(chunk_starts):
            start = bounds[-1]
            # furthest chunk with cum[j] - cum[start] <= seq_len
            j = int(np.searchsorted(cum, cum[start] + seq_len, side="right")) - 1
            bounds.append(max(j, start + 1))
        self._row_bounds = np.asarray(bounds, np.int64)
        self.num_windows = len(bounds) - 1

    def row(self, i: int):
        seq = self.seq_len
        tokens = np.full(seq, self.eos_id, np.int32)
        targets = np.full(seq, self.eos_id, np.int32)
        segment_ids = np.zeros(seq, np.int32)
        positions = np.zeros(seq, np.int32)
        loss_mask = np.zeros(seq, np.float32)
        off = 0
        lo, hi = self._row_bounds[i], self._row_bounds[i + 1]
        for seg, ci in enumerate(range(lo, hi), start=1):
            s, e = int(self._chunk_starts[ci]), int(self._chunk_ends[ci])
            n = e - s
            doc = np.asarray(self.tokens[s:e], np.int32)
            tokens[off : off + n] = doc
            # next-token targets within the document; the final position's
            # target would cross into the next document — mask it
            targets[off : off + n - 1] = doc[1:]
            loss_mask[off : off + n - 1] = 1.0
            segment_ids[off : off + n] = seg
            positions[off : off + n] = np.arange(n)
            off += n
        return tokens, targets, segment_ids, positions, loss_mask

    def batch(self, order: np.ndarray) -> TextBatch:
        rows = [self.row(int(i)) for i in order]
        stack = lambda j: np.stack([r[j] for r in rows])
        return TextBatch(
            tokens=stack(0),
            targets=stack(1),
            segment_ids=stack(2),
            positions=stack(3),
            loss_mask=stack(4),
        )
