"""Checkpoints and serving weight sets: the port of
``tpu_parallel/checkpoint/io.py``.

The JAX package saves with orbax; the card has no orbax, so the port writes
its own format: one ``torch.save`` file per step directory, read back with
``torch.load(weights_only=True)``.  State crosses the two packages through
``models/convert.py`` (``params_from_jax`` / ``params_to_jax``), and the
serving weight set's fingerprint is the JAX package's digest of the same
weights.

An orbax save is safe to run behind the next step because JAX arrays are
immutable.  The port's state is updated in place, so a save first enqueues
a snapshot of every tensor into pinned host memory on the current stream,
before ``save`` returns; the next step's in-place updates queue behind it on
that stream.  Only the file write runs in a background thread.

A sharded state (FSDP or tensor parallelism: ``DTensor`` leaves in its
``state_dict``; pipeline parallelism: stage-owned leaves, each rank's
under its own layers' names) is saved
with ``torch.distributed.checkpoint``, which plays orbax's role: every rank
writes its own shards into the step directory, and a restore reads into the
layout of the state it is given (a fresh init's: JAX restores onto
``abstract_state_of``, an abstract evaluation torch does not have), each
rank its own slices, in place.  A shard's snapshot stays on the host as
well: its ``DTensor`` view is placed on a CPU twin of the state's mesh.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import threading
import warnings
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from tpu_parallel_torch.core.state import map_tensors

_STATE_FILE = "state.pt"
_PARAMS_FILE = "params.pt"
_DCP_METADATA = ".metadata"  # torch.distributed.checkpoint's index of a sharded save


def _open_file(path, mode="r", **kwargs):
    """Manifest reads/writes go through the injectable IO fault shim, as in
    the JAX package (the fingerprint check is only as strong as the IO it
    reads through)."""
    from tpu_parallel_torch.daemon.iofaults import open_file

    return open_file(path, mode, **kwargs)


def snapshot_to_host(tree):
    """Host copies of every tensor of ``tree``: a CUDA tensor is copied into
    pinned memory with ``non_blocking=True`` on the current stream (the
    copy is enqueued, not finished, when this returns); a CPU tensor is
    cloned.  Returns ``(snapshot, event)``, the event recorded after the
    copies (None when nothing is on a CUDA device)."""
    on_cuda = []

    def copy(t: torch.Tensor) -> torch.Tensor:
        if hasattr(t, "to_local"):  # a DTensor shard: its local slice, same placement
            from torch.distributed.tensor import DTensor

            return DTensor.from_local(copy(t.to_local()), _host_mesh(t.device_mesh),
                                      t.placements, run_check=False)
        t = t.detach()
        if t.device.type != "cuda":
            return t.clone()
        on_cuda.append(t)
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        return host

    snapshot = map_tensors(copy, tree)
    event = None
    if on_cuda:
        event = torch.cuda.Event()
        event.record()
    return snapshot, event


# the CPU twin of each device mesh a snapshot was taken on
_HOST_MESHES: Dict[Any, Any] = {}


def _host_mesh(mesh):
    """``mesh`` with device type ``"cpu"``: the same ranks, axis names and
    process groups.  A host snapshot's ``DTensor`` is placed on it, since
    ``DTensor.from_local`` moves its local tensor to the mesh's device type
    (on a ``"cuda"`` mesh, back onto the card)."""
    if mesh.device_type == "cpu":
        return mesh
    if mesh not in _HOST_MESHES:
        from torch.distributed.device_mesh import DeviceMesh

        _HOST_MESHES[mesh] = DeviceMesh.from_group(
            [mesh.get_group(i) for i in range(mesh.ndim)], "cpu", mesh.mesh,
            mesh_dim_names=mesh.mesh_dim_names)
    return _HOST_MESHES[mesh]


def _step_dirs(directory: str) -> Dict[int, str]:
    """Complete step directories (``<step>/``; a ``<step>.tmp/`` is a write
    in progress or one a crash cut short)."""
    if not os.path.isdir(directory):
        return {}
    return {int(name): os.path.join(directory, name) for name in os.listdir(directory)
            if name.isdigit() and any(os.path.isfile(os.path.join(directory, name, f))
                                      for f in (_STATE_FILE, _DCP_METADATA))}


def _is_sharded(tree) -> bool:
    """True when a rank holds only part of ``tree``: a ``DTensor`` shard, or
    a pipeline stage's leaf (each rank checkpoints its own keys)."""
    from tpu_parallel_torch.parallel.pp import stage_info

    found = []
    map_tensors(lambda t: found.append(hasattr(t, "to_local") or stage_info(t) is not None),
                tree)
    return any(found)


# one gloo group per process group for checkpoint IO: a background write's
# collectives must not interleave with the training step's on its groups
_IO_GROUPS: Dict[Any, Any] = {}


def _io_group(group):
    if group not in _IO_GROUPS:
        _IO_GROUPS[group] = dist.new_group(dist.get_process_group_ranks(group), backend="gloo")
    return _IO_GROUPS[group]


class Checkpointer:
    """Train-state checkpoints in one run directory, one subdirectory per
    step, at most ``max_to_keep`` of them (the oldest pruned).

    ``save`` snapshots the state on its stream and returns; a background
    thread writes ``<step>.tmp/state.pt`` and renames it to ``<step>/``, so
    :attr:`latest_step` sees only complete saves.  One write is in flight at
    a time: a save first waits for the previous one.  A write's error is
    raised by the next :meth:`wait`, :meth:`save` or :meth:`close`.

    Under a process ``group`` with a replicated state (the same on every
    rank) rank 0 of the group writes and the others skip the write; with a
    sharded state every rank writes its shards (``torch.distributed.
    checkpoint``, its collectives on a gloo group of the same ranks) and
    rank 0 renames the directory.  Every :meth:`wait` ends at a barrier of
    the group, so after it every rank sees the saves on disk.  Every rank
    of the group must then call :meth:`save`, :meth:`wait`,
    :meth:`restore` and :meth:`close` at the same points.
    """

    def __init__(self, directory: str, max_to_keep: int = 3, *, group=None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.group = group
        self.writer = group is None or dist.get_rank(group) == 0
        os.makedirs(self.directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._io = None  # the gloo group of a sharded save in flight

    def save(self, step: int, state, *, wait: bool = False) -> None:
        """Checkpoint ``state`` (a ``TrainState`` or its ``state_dict()``)
        as step ``step``."""
        self.wait()
        payload = state.state_dict() if hasattr(state, "state_dict") else state
        sharded = _is_sharded(payload)
        if sharded and self.group is None:
            raise ValueError("a sharded state is saved by every rank: give the "
                             "Checkpointer its process group")
        if self.writer or sharded:
            snapshot, event = snapshot_to_host(payload)
            self._io = _io_group(self.group) if sharded else None
            self._thread = threading.Thread(target=self._write, args=(step, snapshot, event),
                                            name=f"checkpoint-{step}", daemon=True)
            self._thread.start()
        if wait:
            self.wait()

    def _write(self, step: int, snapshot, event) -> None:
        """Write ``snapshot`` into ``<step>.tmp/``, rename it to ``<step>/``
        and prune: one ``torch.save`` file, or for a sharded state (``_io``,
        the save's gloo group) every rank's shards through
        ``torch.distributed.checkpoint``, the directory made and renamed by
        rank 0."""
        io = self._io
        try:
            if event is not None:
                event.synchronize()
            final = os.path.join(self.directory, str(step))
            tmp = final + ".tmp"
            if self.writer:
                shutil.rmtree(tmp, ignore_errors=True)
                os.makedirs(tmp)
            if io is None:
                with open(os.path.join(tmp, _STATE_FILE), "wb") as fh:
                    torch.save(snapshot, fh)
                    fh.flush()
                    os.fsync(fh.fileno())
            else:
                import torch.distributed.checkpoint as dcp

                dist.barrier(group=io)  # the directory exists
                dcp.save(snapshot, storage_writer=dcp.FileSystemWriter(tmp, sync_files=True),
                         process_group=io)
                dist.barrier(group=io)  # every rank's shards are on disk
            if self.writer:
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.rename(tmp, final)
                steps = sorted(_step_dirs(self.directory))
                for old in steps[:max(0, len(steps) - self.max_to_keep)]:
                    shutil.rmtree(os.path.join(self.directory, str(old)), ignore_errors=True)
        except BaseException as exc:  # noqa: BLE001 — re-raised by wait()
            self._error = exc

    def wait(self) -> None:
        """Block until the write in flight is on disk (under a group: on
        every rank, at a barrier); raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.group is not None:
            dist.barrier(group=self.group)
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    @property
    def latest_step(self) -> Optional[int]:
        steps = _step_dirs(self.directory)
        return max(steps) if steps else None

    def bytes_on_disk(self, step: int) -> int:
        path = os.path.join(self.directory, str(step))
        return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))

    def _path(self, step: Optional[int]) -> str:
        step = step if step is not None else self.latest_step
        path = _step_dirs(self.directory).get(step) if step is not None else None
        if path is None:
            raise FileNotFoundError(f"no checkpoint found in {self.directory}"
                                    + ("" if step is None else f" for step {step}"))
        return path

    def load(self, step: Optional[int] = None) -> Dict[str, Any]:
        """The saved ``state_dict`` of ``step`` (default: the latest) on the
        CPU; ``FileNotFoundError`` when there is none.  A sharded save has no
        single-process form: :meth:`restore` it into a state."""
        path = self._path(step)
        if not os.path.isfile(os.path.join(path, _STATE_FILE)):
            raise ValueError(f"{path} is a sharded checkpoint: restore it into a state")
        return torch.load(os.path.join(path, _STATE_FILE), map_location="cpu",
                          weights_only=True)

    def restore(self, state, step: Optional[int] = None):
        """Load step ``step`` (default: the latest) into ``state``, a
        ``TrainState``, in place; returns it.

        Structure drift in the optional EMA shadow is absorbed, with a
        warning: a checkpoint written with EMA restores into a state
        without it (the shadow is dropped), and one written without EMA
        restores into a state with it as ``ema_params = None`` (the trainer
        reseeds it from the restored masters).  Any other mismatch raises.
        A sharded save restores into a sharded state of the same layout,
        each rank reading its slices straight into the state's buffers.
        """
        path = self._path(step)
        if os.path.isfile(os.path.join(path, _DCP_METADATA)):
            return self._restore_sharded(state, path)
        payload = self.load(step)
        step = int(payload["step"])
        if payload.get("ema_params") is not None and state.ema_params is None:
            warnings.warn(f"checkpoint at step {step} keeps 'ema_params' that this state "
                          "does not; dropping it", stacklevel=2)
            payload["ema_params"] = None
        elif payload.get("ema_params") is None and state.ema_params is not None:
            warnings.warn(f"checkpoint at step {step} has no usable 'ema_params'; "
                          "restoring it as None", stacklevel=2)
            state.ema_params = None
        state.load(payload)
        return state

    def _restore_sharded(self, state, path: str):
        import torch.distributed.checkpoint as dcp

        if self.group is None:
            raise ValueError("a sharded checkpoint is restored by every rank: give the "
                             "Checkpointer its process group")
        reader = dcp.FileSystemReader(path)
        saved_ema = any(k.startswith("ema_params.")
                        for k in reader.read_metadata().state_dict_metadata)
        if saved_ema and state.ema_params is None:
            warnings.warn(f"checkpoint {path} keeps 'ema_params' that this state does not; "
                          "dropping it", stacklevel=3)
        elif not saved_ema and state.ema_params is not None:
            warnings.warn(f"checkpoint {path} has no usable 'ema_params'; restoring it as "
                          "None", stacklevel=3)
            state.ema_params = None
        # the state's own buffers (sharded ones as DTensor views) are the
        # target: every tensor is read in place
        target = state.state_dict()
        if saved_ema != (state.ema_params is not None):
            del target["ema_params"]
        dcp.load(target, storage_reader=reader, process_group=_io_group(self.group))
        target.setdefault("ema_params", None)
        state.load(target)
        return state

    def close(self) -> None:
        self.wait()


# -- serving weight sets (the hot-swap unit) --------------------------------
#
# A serving weight set is the JAX-layout parameter tree (nested dicts, as
# ``convert.params_to_jax`` builds it) plus a JSON manifest with a version
# and a content fingerprint, so a corrupted or mixed-up file set is refused
# before a replica serves it.


class WeightsCorrupt(ValueError):
    """Loaded weights do not match their manifest fingerprint — the file
    set was truncated, tampered with, or mixed from two saves.  Serving
    such weights would be silent garbage; refuse loudly instead."""


@dataclasses.dataclass(frozen=True)
class WeightManifest:
    """Sidecar identity record of one saved serving weight set."""

    version: str
    step: int
    fingerprint: str
    n_leaves: int
    n_params: int

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "WeightManifest":
        return cls(**json.loads(text))


def _leaves_with_paths(tree: Mapping, prefix: str = ""):
    """``(path, leaf)`` in JAX's flatten order for a tree of dicts (keys
    sorted), the path spelled as ``jax.tree_util.keystr`` spells it."""
    for key in sorted(tree):
        path = f"{prefix}[{key!r}]"
        value = tree[key]
        if isinstance(value, Mapping):
            yield from _leaves_with_paths(value, path)
        else:
            yield path, value


def _leaf_bytes(leaf):
    """``(shape, dtype name, raw bytes)`` of one leaf as numpy would give
    them; a bf16 tensor is named ``"bfloat16"`` and hashed as its raw bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return tuple(t.shape), "bfloat16", t.view(torch.uint16).numpy().tobytes()
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    name = (arr.dtype.metadata or {}).get("dtype", str(arr.dtype))
    return tuple(arr.shape), name, np.ascontiguousarray(arr).tobytes()


def params_fingerprint(params: Mapping) -> str:
    """Deterministic content hash of a JAX-layout parameter tree: sha256
    over every leaf's path, shape, dtype name and raw bytes, in JAX's
    flatten order, so the JAX package's ``params_fingerprint`` gives the
    same digest for the same weights."""
    h = hashlib.sha256()
    for path, leaf in _leaves_with_paths(params):
        shape, dtype, raw = _leaf_bytes(leaf)
        h.update(path.encode())
        h.update(str(shape).encode())
        h.update(dtype.encode())
        h.update(raw)
    return h.hexdigest()


def _manifest_path(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), f"weights_manifest_{step}.json")


def _weights_dir(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), f"weights_{step}")


def save_serving_weights(directory: str, step: int, params: Mapping,
                         version: Optional[str] = None) -> WeightManifest:
    """Write a hot-swappable weight set: the JAX-layout parameter tree
    (``weights_<step>/params.pt``) plus its :class:`WeightManifest`.
    ``version`` defaults to ``"step-<step>"``."""
    host = map_tensors(lambda t: t.detach().cpu(), params)
    leaves = [leaf for _, leaf in _leaves_with_paths(host)]
    manifest = WeightManifest(
        version=version if version is not None else f"step-{step}",
        step=step,
        fingerprint=params_fingerprint(host),
        n_leaves=len(leaves),
        n_params=int(sum(leaf.numel() for leaf in leaves)),
    )
    path = _weights_dir(directory, step)
    os.makedirs(path, exist_ok=True)
    torch.save(host, os.path.join(path, _PARAMS_FILE))
    with _open_file(_manifest_path(directory, step), "w") as fh:
        fh.write(manifest.to_json())
        fh.write("\n")
    return manifest


def latest_weights_step(directory: str) -> Optional[int]:
    """Largest step with a manifest in ``directory`` (None when empty)."""
    steps = []
    if os.path.isdir(directory):
        for name in os.listdir(directory):
            if name.startswith("weights_manifest_") and name.endswith(".json"):
                steps.append(int(name[len("weights_manifest_"):-len(".json")]))
    return max(steps) if steps else None


def load_serving_weights(directory: str, step: Optional[int] = None,
                         like: Optional[Mapping] = None) -> tuple:
    """Restore a weight set saved by :func:`save_serving_weights` and VERIFY
    it against its manifest.  ``like`` (a tree of the same structure) casts
    each leaf to its template's dtype and device.  Returns ``(params,
    manifest)``; raises ``FileNotFoundError`` when nothing is saved and
    :class:`WeightsCorrupt` when the content hash disagrees with the
    manifest (or the payload does not load)."""
    if step is None:
        step = latest_weights_step(directory)
        if step is None:
            raise FileNotFoundError(f"no serving weights saved under {directory}")
    mpath = _manifest_path(directory, step)
    if not os.path.exists(mpath):
        raise FileNotFoundError(f"no weight manifest at {mpath}")
    with _open_file(mpath) as fh:
        manifest = WeightManifest.from_json(fh.read())
    path = _weights_dir(directory, step)
    try:
        restored = torch.load(os.path.join(path, _PARAMS_FILE), map_location="cpu",
                              weights_only=True)
    except (RuntimeError, ValueError, EOFError) as exc:
        raise WeightsCorrupt(f"weights at {path} do not load ({exc}); refusing to serve "
                             f"version {manifest.version!r}") from exc
    if like is not None:
        restored = _like(restored, like)
    digest = params_fingerprint(restored)
    if digest != manifest.fingerprint:
        raise WeightsCorrupt(
            f"weights at {path} hash {digest[:12]}… but the manifest "
            f"records {manifest.fingerprint[:12]}… (version "
            f"{manifest.version!r}, step {step}) — refusing to serve a "
            "corrupted or mismatched weight set"
        )
    return restored, manifest


def _like(tree: Mapping, like: Mapping) -> Dict:
    out = {}
    for key, value in tree.items():
        if isinstance(value, Mapping):
            out[key] = _like(value, like[key])
        else:
            out[key] = value.to(device=like[key].device, dtype=like[key].dtype)
    return out
