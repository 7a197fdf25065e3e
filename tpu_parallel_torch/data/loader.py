"""Token-stream data loading: the port of ``tpu_parallel/data/loader.py``.

- :class:`TokenDataset` (copied; numpy) reads flat uint16 token files
  through ``np.memmap`` and cuts deterministic ``seq_len + 1`` windows.
- :func:`to_device` lifts a host batch onto this process's device (pinned
  host tensors, ``non_blocking=True``, int64 token ids): one process feeds
  one device.
- :func:`make_global_batch` is the global view of the ranks' local batches:
  a ``DTensor`` sharded over the data axis (and the seq axis, by token
  block), stitched with no gather.
- :class:`DataLoader` composes them into the iterator the ``Trainer``
  consumes; ``batch_at(step)`` is a pure function of ``(seed, step)``,
  process ``p`` of ``P`` takes rows ``p::P`` of every global batch and,
  under sequence parallelism, seq rank ``q`` of ``Q`` the ``q``-th block of
  each row's tokens.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist

from tpu_parallel_torch.core.state import TextBatch
from tpu_parallel_torch.runtime import resolve_device


class TokenDataset:
    """Windows over flat token streams (memmap file(s) or in-memory array).

    ``tokens`` may be one path / array, or a **list** of paths/arrays — a
    sharded corpus.  Windows never cross shard boundaries (each shard
    contributes ``(len - 1) // seq_len`` windows); shards stay memmapped,
    so corpus size never hits RAM.
    """

    def __init__(self, tokens, seq_len: int):
        if not isinstance(tokens, (list, tuple)):
            tokens = [tokens]
        self.shards = [
            np.memmap(t, dtype=np.uint16, mode="r") if isinstance(t, str) else t
            for t in tokens
        ]
        self.seq_len = seq_len
        per_shard = [max(0, (len(s) - 1) // seq_len) for s in self.shards]
        # cumulative window counts: window i lives in the shard whose
        # cumulative range contains i
        self._cum = np.cumsum([0] + per_shard)
        self.num_windows = int(self._cum[-1])
        if self.num_windows <= 0:
            raise ValueError(
                f"streams of {[len(s) for s in self.shards]} tokens too "
                f"short for seq_len={seq_len}"
            )

    @staticmethod
    def write_bin(path: str, tokens: np.ndarray) -> None:
        """Write a token array in the flat uint16 format ``__init__`` reads."""
        np.asarray(tokens, dtype=np.uint16).tofile(path)

    def window(self, i: int) -> np.ndarray:
        """Window ``i``: ``seq_len + 1`` tokens (inputs + shifted targets)."""
        shard = int(np.searchsorted(self._cum, i, side="right")) - 1
        start = (i - int(self._cum[shard])) * self.seq_len
        return np.asarray(
            self.shards[shard][start : start + self.seq_len + 1], np.int32
        )

    def batch(self, order: np.ndarray) -> TextBatch:
        """Assemble the windows in ``order`` into a TextBatch (numpy)."""
        rows = np.stack([self.window(int(i)) for i in order])
        seq = self.seq_len
        return TextBatch(
            tokens=rows[:, :-1],
            targets=rows[:, 1:],
            loss_mask=np.ones((len(order), seq), np.float32),
            positions=np.broadcast_to(np.arange(seq), (len(order), seq)),
        )


# field -> dtype on the device: token ids int64 (the embedding lookup's
# index type), segment ids int32 (what the flash kernels read)
_DEVICE_DTYPES = dict(tokens=torch.int64, targets=torch.int64, positions=torch.int64,
                      segment_ids=torch.int32, loss_mask=torch.float32)


def to_device(batch: TextBatch, device) -> TextBatch:
    """A numpy ``TextBatch`` on ``device``: each field a pinned host tensor
    copied with ``non_blocking=True`` (plain tensors on a CPU device)."""
    dev = torch.device(device)
    out = {}
    for name, dtype in _DEVICE_DTYPES.items():
        value = getattr(batch, name)
        if value is None:
            out[name] = None
            continue
        host = torch.from_numpy(np.ascontiguousarray(value)).to(dtype)
        if dev.type == "cuda":
            out[name] = host.pin_memory().to(dev, non_blocking=True)
        else:
            out[name] = host.to(dev)
    return TextBatch(**out)


def make_global_batch(local_batch: TextBatch, mesh, batch_spec=("data",)) -> TextBatch:
    """Lift each rank's local part into one global batch: every field a
    ``DTensor`` over ``mesh``, dim ``i`` sharded along the axis
    ``batch_spec[i]`` names and replicated along the others (JAX's
    ``P("data")``, or ``P("data", "seq")`` under sequence parallelism:
    ``Trainer.batch_spec``), built with ``DTensor.from_local`` (no
    gather).  Its global rows (token blocks) are the ranks' in coordinate
    order, rank 0's first, as JAX's device order.  Without a mesh the
    local batch is the global one."""
    if mesh is None:
        return local_batch
    from torch.distributed.tensor import DTensor, Replicate, Shard

    dims = {name: i for i, name in enumerate(batch_spec) if name is not None}
    placements = [Shard(dims[name]) if name in dims else Replicate()
                  for name in mesh.mesh_dim_names]

    def lift(x):
        return None if x is None else DTensor.from_local(x, mesh, placements, run_check=False)

    return type(local_batch)(**{f.name: lift(getattr(local_batch, f.name))
                                for f in dataclasses.fields(local_batch)})


@dataclasses.dataclass
class DataLoader:
    """Seeded, rank-aware iterator of device TextBatches.

    Each epoch draws a fresh permutation of window indices from a ``numpy``
    RNG seeded by ``(seed, epoch)``; process ``p`` of ``P`` takes rows
    ``p::P`` of every global batch, disjoint coverage with no coordination.
    ``process_count``/``process_index`` default to the process group's
    world size and rank (1 and 0 without one).  ``seq_count``/``seq_index``
    (a seq axis's size and this rank's coordinate: ``Trainer.seq_size`` /
    ``seq_index``) hand the rank its block of each row's ``seq_len``
    tokens, as JAX's ``P("data", "seq")`` lays the batch out: tokens,
    targets, global positions, segment ids and loss mask alike.  ``device``
    defaults to ``"cuda"`` and raises without a GPU.
    """

    dataset: Any
    global_batch_size: int
    seed: int = 0
    # held-out evaluation: the LAST ``round(holdout_fraction * num_windows)``
    # windows of the stream never enter the train split.  ``split="train"``
    # samples the head, ``split="eval"`` (see :meth:`eval_view`) the tail —
    # disjoint window sets; adjacent windows share one boundary token, so
    # eval *targets* never appear as train targets.
    holdout_fraction: float = 0.0
    split: str = "train"
    device: Any = "cuda"
    process_count: Optional[int] = None
    process_index: Optional[int] = None
    seq_count: int = 1
    seq_index: int = 0

    def __post_init__(self):
        up = dist.is_initialized()
        if self.process_count is None:
            self.process_count = dist.get_world_size() if up else 1
        if self.process_index is None:
            self.process_index = dist.get_rank() if up else 0
        if not 0 <= self.process_index < self.process_count:
            raise ValueError(f"process {self.process_index} of {self.process_count}")
        if self.global_batch_size % self.process_count:
            raise ValueError(
                f"global batch {self.global_batch_size} not divisible by "
                f"process count {self.process_count}"
            )
        if not 0 <= self.seq_index < self.seq_count:
            raise ValueError(f"seq block {self.seq_index} of {self.seq_count}")
        if self.dataset.seq_len % self.seq_count:
            raise ValueError(f"seq_len {self.dataset.seq_len} not divisible by seq count "
                             f"{self.seq_count}")
        self.device = resolve_device(self.device)
        self.local_batch_size = self.global_batch_size // self.process_count
        if not 0.0 <= self.holdout_fraction < 1.0:
            raise ValueError(f"holdout_fraction={self.holdout_fraction} not in [0, 1)")
        n_eval = int(round(self.dataset.num_windows * self.holdout_fraction))
        if self.split == "train":
            self._window_offset = 0
            self.num_windows = self.dataset.num_windows - n_eval
        elif self.split == "eval":
            if n_eval == 0:
                raise ValueError(
                    "split='eval' needs holdout_fraction > 0 (no held-out windows)"
                )
            self._window_offset = self.dataset.num_windows - n_eval
            self.num_windows = n_eval
        else:
            raise ValueError(f"unknown split {self.split!r}")
        if self.num_windows < self.global_batch_size:
            raise ValueError(
                f"{self.split} split has {self.num_windows} windows — fewer "
                f"than one global batch of {self.global_batch_size}"
            )

    def eval_view(self) -> "DataLoader":
        """The held-out counterpart of this loader (same stream, disjoint tail)."""
        return dataclasses.replace(self, split="eval")

    @property
    def batches_per_epoch(self) -> int:
        return self.num_windows // self.global_batch_size

    def _epoch_order(self, epoch: int) -> np.ndarray:
        if getattr(self, "_order_epoch", None) != epoch:
            self._order_epoch = epoch
            self._order = np.random.default_rng((self.seed, epoch)).permutation(
                self.num_windows
            )
        return self._order

    def batch_at(self, step: int) -> TextBatch:
        """The batch for absolute training step ``step`` (0-based).

        Pure function of ``(seed, step)`` — the contract that makes
        checkpoint resume and failure rollback replay the exact data order
        (``Trainer.fit`` feeds from this when given a loader).
        """
        epoch, b = divmod(step, self.batches_per_epoch)
        order = self._epoch_order(epoch)
        rows = order[b * self.global_batch_size : (b + 1) * self.global_batch_size]
        rows = rows + self._window_offset
        local = self.dataset.batch(rows[self.process_index :: self.process_count])
        if self.seq_count > 1:
            t = self.dataset.seq_len // self.seq_count
            local = local.cols(self.seq_index * t, (self.seq_index + 1) * t)
        return to_device(local, self.device)

    def epoch(self, epoch: int) -> Iterator[TextBatch]:
        for b in range(self.batches_per_epoch):
            yield self.batch_at(epoch * self.batches_per_epoch + b)

    def __iter__(self) -> Iterator[TextBatch]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1

    def prefetch(self, lookahead: int = 2) -> Iterator[TextBatch]:
        """Iterate with ``lookahead`` batches assembled ahead of consumption.

        The host-to-device copies are issued without waiting, so holding the
        next batches in flight overlaps window assembly and the copy with the
        device's current step.  ``lookahead <= 0`` degrades to plain
        iteration.
        """
        import collections
        import itertools

        it = iter(self)
        if lookahead <= 0:
            return it

        def gen():
            queue = collections.deque(itertools.islice(it, lookahead))
            while queue:
                yield queue.popleft()
                nxt = next(it, None)
                if nxt is not None:
                    queue.append(nxt)

        return gen()
