"""Process-group plumbing shared by the port's collectives: the registry
of groups by name (a custom op's schema takes a string, not a group) and
one round of point-to-point exchanges.  Tensor parallelism's collectives,
the pipeline's hops, the ring's rotations and Ulysses' all-to-alls all
build on these."""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import torch
import torch.distributed as dist

# process groups by name, for the custom ops
GROUPS: Dict[str, Any] = {}


def group_name(group) -> str:
    """Register ``group`` under its name and return the name."""
    name = group.group_name
    GROUPS[name] = group
    return name


def post_exchange(group, sends: Sequence[Tuple[torch.Tensor, int]],
                  recvs: Sequence[Tuple[torch.Tensor, int]]) -> None:
    """One round of point-to-point ops on ``group``: send each ``(tensor,
    coordinate)`` and receive into each ``(buffer, coordinate)``, posted
    together (``batch_isend_irecv``) and waited for.  Gloo's point-to-point
    ops hand the tensor's data pointer to the TCP transport, which cannot
    read device memory, so over gloo a CUDA tensor is staged through a
    pinned host buffer both ways.  Counts nothing: each caller counts its
    own (the pipeline's hops, the ring's rotations)."""
    if not sends and not recvs:
        return
    staged = dist.get_backend(group) == "gloo"
    ops, back = [], []
    for t, coord in sends:
        t = t.detach().contiguous()
        if staged and t.is_cuda:
            t = torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)
        ops.append(dist.P2POp(dist.isend, t, dist.get_global_rank(group, coord), group))
    for buf, coord in recvs:
        target = buf
        if staged and buf.is_cuda:
            target = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
            back.append((buf, target))
        ops.append(dist.P2POp(dist.irecv, target, dist.get_global_rank(group, coord), group))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    for buf, host in back:
        buf.copy_(host)
