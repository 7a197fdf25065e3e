"""Random streams across mesh axes: the port of ``tpu_parallel/core/rng.py``.

JAX folds the device's mesh coordinate into a key.  Here a key is a CPU
``torch.Generator``: :func:`fold_rng_over_axis` draws one seed from it and
mixes in this rank's coordinate along each named axis, giving a new
generator that differs across coordinates and repeats for a given (seed,
coordinate).  The draw advances the caller's generator by the same amount
on every rank, so a replicated generator (``TrainState.rng``) stays equal
across ranks; only the folded one differs.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch

from tpu_parallel_torch.runtime.mesh import axis_group

_MASK = (1 << 64) - 1


def _mix(x: int) -> int:
    """splitmix64's finalizer: a bijection on 64-bit integers whose
    outputs for neighbouring inputs share no structure."""
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9 & _MASK
    x = (x ^ (x >> 27)) * 0x94D049BB133111EB & _MASK
    return x ^ (x >> 31)


def fold_seed(seed: int, *values: int) -> int:
    """``seed`` with each of ``values`` folded in (a golden-ratio step, then
    :func:`_mix`): a non-negative 63-bit seed that repeats for the same
    inputs and shares no structure with its neighbours'."""
    for v in values:
        seed = _mix((seed + 0x9E3779B97F4A7C15 * (v + 1)) & _MASK)
    return seed & (2**63 - 1)


def fold_rng_over_axis(rng: torch.Generator, axis_names: Union[str, Sequence[str]],
                       mesh=None) -> torch.Generator:
    """A generator unique to this rank's coordinates along ``axis_names``.

    Use for anything that must differ per device (dropout on different data
    shards).  Axes that ``mesh`` does not bind (no mesh, or a name it lacks)
    are skipped, as in JAX; when none is bound, ``rng`` itself comes back
    and nothing is drawn, so one device runs exactly as without a mesh.
    """
    if isinstance(axis_names, str):
        axis_names = (axis_names,)
    coords = [bound[2] for bound in (axis_group(mesh, name) for name in axis_names)
              if bound is not None]
    if not coords:
        return rng
    seed = int(torch.randint(0, 2**63 - 1, (1,), generator=rng).item())
    return torch.Generator().manual_seed(fold_seed(seed, *coords))


def split_rng_like(rng: torch.Generator, tree):
    """One new CPU generator per leaf of ``tree`` (dicts, lists and tuples),
    each seeded by a draw from ``rng`` in leaf order."""
    if isinstance(tree, dict):
        return {k: split_rng_like(rng, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(split_rng_like(rng, v) for v in tree)
    seed = int(torch.randint(0, 2**63 - 1, (1,), generator=rng).item())
    return torch.Generator().manual_seed(seed)
