"""Losses: the port of ``tpu_parallel/core/losses.py``: per-token CE, its
vocab-parallel form over a tensor-parallel model axis (with the global
argmax), the causal-LM loss and the classification loss."""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from tpu_parallel_torch.core.rng import fold_rng_over_axis

AxisNames = Union[str, Sequence[str]]


def token_cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-token CE with fp32 math from logits of any dtype: [..., vocab] and
    integer [...] targets -> [...] fp32."""
    vocab = logits.shape[-1]
    ce = F.cross_entropy(
        logits.float().reshape(-1, vocab), targets.reshape(-1).long(), reduction="none"
    )
    return ce.reshape(targets.shape)


def vocab_parallel_argmax(logits: torch.Tensor, axis_name: str, mesh) -> torch.Tensor:
    """Global argmax (int64) over vocab-sharded logits [..., vocab/tp]:
    each shard nominates its local winner, the shards holding the global
    max win, lowest id on ties (``argmax``'s first-occurrence rule on the
    gathered logits).  Two scalar-per-row collectives over ``axis_name``
    of ``mesh`` (a MAX, then a MIN), no gather; without the axis, the
    plain argmax."""
    from tpu_parallel_torch.parallel import tp

    bound = tp.model_axis(mesh, axis_name)
    if bound is None:
        return logits.argmax(-1)
    offset = bound[2] * logits.shape[-1]
    lf = logits.detach().float()
    local_max, local_arg = lf.max(dim=-1)
    global_max = tp.all_reduce(local_max, axis_name, mesh, "max")
    nominee = torch.where(local_max == global_max, (local_arg + offset).to(torch.int32),
                          torch.full_like(local_arg, 2**31 - 1, dtype=torch.int32))
    return tp.all_reduce(nominee, axis_name, mesh, "min").long()


def vocab_parallel_cross_entropy(logits: torch.Tensor, targets: torch.Tensor, axis_name: str,
                                 mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token CE on vocab-sharded logits, with no full-vocabulary gather.

    ``logits`` [..., vocab/tp] is this rank's shard of a column-parallel
    lm_head's output (rank i owns the contiguous ids [i*vs, (i+1)*vs));
    ``targets`` [...] are global ids.  The softmax statistics come from
    three scalar-per-token collectives over ``axis_name``: a MAX of the row
    max (stopped: a stability shift only), a SUM of the shifted
    sum-of-exp and a SUM of the owning shard's target logit.  The sums'
    backward is a sum, so the gradient reaches only this rank's logits, as
    in JAX.  Returns ``(ce, pred)``: fp32 per-token loss and the global
    argmax id (:func:`vocab_parallel_argmax`)."""
    from tpu_parallel_torch.parallel import tp

    bound = tp.model_axis(mesh, axis_name)
    if bound is None:
        return token_cross_entropy(logits, targets), logits.argmax(-1)
    vs = logits.shape[-1]
    offset = bound[2] * vs
    lf = logits.float()
    global_max = tp.all_reduce(lf.detach().amax(dim=-1), axis_name, mesh, "max")
    sum_exp = torch.exp(lf - global_max[..., None]).sum(dim=-1)
    lse = global_max + torch.log(tp.all_reduce(sum_exp, axis_name, mesh))
    t_local = targets.long() - offset
    owns = (t_local >= 0) & (t_local < vs)
    own_logit = lf.gather(-1, t_local.clamp(0, vs - 1)[..., None])[..., 0]
    target_logit = tp.all_reduce(torch.where(owns, own_logit, torch.zeros_like(own_logit)),
                                 axis_name, mesh)
    return lse - target_logit, vocab_parallel_argmax(logits, axis_name, mesh)


def make_lm_loss():
    """Next-token cross-entropy for a ``TextBatch`` with loss masking, on the
    model's full logits: ``loss_fn(model, batch, rng) -> (loss, metrics)``
    with ``(sum, count)`` metrics ``loss`` and ``accuracy``.  ``rng`` is
    unused (no dropout in the port)."""

    def loss_fn(model, batch, rng=None):
        logits = model(batch.tokens, positions=batch.positions)
        loss = token_cross_entropy(logits, batch.targets)
        mask = batch.loss_mask if batch.loss_mask is not None else torch.ones_like(loss)
        n_tok = mask.sum()
        correct = ((logits.argmax(-1) == batch.targets) * mask).sum()
        loss_sum = (loss * mask).sum()
        metrics = {"loss": (loss_sum, n_tok), "accuracy": (correct.float(), n_tok)}
        return loss_sum / n_tok.clamp(min=1.0), metrics

    return loss_fn


def make_classification_loss(fold_axes: AxisNames = "data", mesh=None):
    """Softmax CE for a ``Batch``: ``loss_fn(model, batch, rng) -> (loss,
    metrics)``, the batch mean, with ``(sum, count)`` metrics ``loss`` and
    ``accuracy``.  Dropout draws from ``rng`` folded over ``fold_axes`` of
    ``mesh`` (per-rank masks; no mesh: ``rng`` itself)."""

    def loss_fn(model, batch, rng):
        dropout_rng = fold_rng_over_axis(rng, fold_axes, mesh)
        logits = model(batch.inputs, train=True, rng=dropout_rng)
        loss = F.cross_entropy(logits, batch.labels.long(), reduction="none")
        correct = (logits.argmax(-1) == batch.labels).sum()
        bs = torch.tensor(float(batch.labels.numel()), device=logits.device)
        metrics = {"loss": (loss.sum(), bs), "accuracy": (correct.float(), bs)}
        return loss.mean(), metrics

    return loss_fn
