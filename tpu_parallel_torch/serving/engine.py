"""Continuous-batching inference engine: the port of
``tpu_parallel/serving/engine.py`` (fixed-slot or block-paged pool, FIFO
scheduler, bucketed / exact / chunked prefill, aligned-LRU prefix reuse,
per-step, fused and unified ragged ticks).

The engine decodes the SLOT POOL: every tick runs one decode step (or,
by default, a FUSED tick of ``decode_steps_per_tick`` = 8 masked steps)
over all ``n_slots`` rows, and requests join (prefill into a freed slot)
and leave (EOS / length) between ticks.

- Rows sit at different depths of their generations, so each decode
  step writes row r's K/V at its own column ``write_index[r]`` (the
  ``write_index`` path of ``models/layers.py``); the attention mask keys
  off stored positions.  Free and mid-chunked-prefill rows aim their
  writes at column ``seq_len``, which the cache drops.
- ``kv_block_tokens`` > 0 (or ``"auto"``) swaps the fixed ``n_slots x
  seq_len`` pool for a pool of blocks addressed through per-slot block
  tables (:class:`PagedCachePool`): slot count decouples from
  ``seq_len``, admission reserves blocks (a block gate that holds the
  queue head), prefix hits are refcounted table writes, and a write into
  a shared block copies that one block first.
- Sampling knobs are per-request tensors (:func:`sample_tokens`), so
  requests with different knobs share a tick.
- Prefill: prompts pad RIGHT to a geometric bucket and same-bucket
  admissions run as one batched call padded to ``prefill_batch`` rows
  (dummy rows are dropped); prompts above ``prefill_chunk_tokens`` split
  into chunks, one per tick, extending the slot's row through
  ``prefill_extend_step``; ``prefix_cache_size`` keeps bucket-aligned
  prompt prefixes that seed a fresh slot on a hit.  All of it is exact:
  greedy tokens equal an exact-length prefill's.
- The fused tick keeps the per-slot state (token, position, write index,
  live mask, remaining budget) in device tensors between ticks; the host
  rewrites them in place only after admissions and releases.  The
  UNIFIED ragged tick (the default with a fused tick and chunked
  prefill) folds every in-flight chunk into the same tick: one
  ``[n_slots, chunk]`` extend over the pool, in-device activation of the
  slots whose prompt completes, then the T decode steps.  On a CUDA
  device each body is captured ONCE as a CUDA graph (the counterpart of
  JAX's donated dispatch): the fused one, and the unified one beside it,
  and every tick is one replay plus one device-to-host copy of the token
  block; slot state, knobs, chunk operands, outputs, the block table and
  the cache pool keep fixed addresses for that.  On the CPU the same
  bodies run eagerly.  A capture that fails raises.
- ``launch`` / ``collect`` split a tick at its one sync, and
  ``run(overlap=True)`` launches the next pure-decode tick before
  collecting the previous one.
- Hierarchical KV memory (paged only, :mod:`~tpu_parallel_torch.serving.
  kv_hierarchy`): ``kv_radix_cache`` swaps the aligned-LRU prefix cache for
  a token-level radix tree over the block pool (any shared prefix hits at
  block granularity, frequency-aware eviction); ``kv_host_blocks`` adds a
  host-RAM tier below it (evicted-but-warm blocks spill through one gather
  and device-to-host copy and restore through one host-to-device copy and
  scatter instead of a re-prefill); ``kv_disk_dir`` / ``kv_disk_blocks``
  add a disk tier below that, which a restarted engine boots warm from.
  ``export_prefix`` / ``export_hot_prefixes`` / ``import_prefix`` move a
  KV prefix between engines, of either package, as self-checking bytes
  (:mod:`~tpu_parallel_torch.serving.kv_wire`).  All of it runs at
  admission, on the host side of the tick, never inside a captured body.
- Speculative decoding (``draft_tokens`` > 0, :mod:`~tpu_parallel_torch.
  serving.spec_decode`): each decode tick becomes a draft-verify block of
  width ``draft_tokens + 1`` per slot, one multi-token forward that emits
  the accepted drafts plus a bonus token, greedy tokens unchanged.
  Per-step ticks draft on the host (any :class:`Drafter`); fused ticks
  (``decode_steps_per_tick`` > 1) run T blocks in one body, drafting on
  the device from a fixed-address token history with the n-gram drafter's
  tensor twin, and under the unified tick the chunk phase rides in front.
  On a CUDA device each spec body is captured once, like the others.

Every tick runs over either cache dtype: under ``kv_cache_dtype="int8"``
the pool's int8 payloads and fp32 scale stores are fixed-address like the
bf16 ones, and the transient casts of the int8 read live in each graph's
private pool.

Mesh serving: pass ``mesh`` (the one the model was built on,
``GPTLM(config, mesh=mesh)``) and the engine serves a tensor-parallel
model: the fixed-slot pool holds each rank's kv heads (the model's
``init_cache`` allocates them; their layout in JAX's names is
:func:`~tpu_parallel_torch.serving.cache_pool.cache_partition_specs`),
the lm_head's logits are all-gathered, and every rank of the mesh runs the
same host loop over replicated slots, sampling from one generator in the
same state (JAX's ``fold_axes=()``).  So that the ranks never decide
alone (a rank that does deadlocks the next collective), the engine's
clock under a mesh is the maximum of the ranks' clocks, one all-reduce per
reading: admission, expiry and every deadline see the same time on every
rank; the NaN sentinel reads the gathered logits, the same on every rank;
and a caller cancels or submits on every rank alike.  JAX's mesh limits
hold, with its words: no paged pool, ``decode_steps_per_tick`` 1 (so no
unified tick and no CUDA graph).
"""

from __future__ import annotations

import math
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from tpu_parallel_torch.models.generate import (
    decode_step,
    padded_prefill_inputs,
    prefill_extend_step,
    prefill_step,
    verify_step,
)
from tpu_parallel_torch.obs.registry import MetricRegistry
from tpu_parallel_torch.obs.tracer import NULL_TRACER, Tracer
from tpu_parallel_torch.serving.cache_pool import (
    CachePool,
    KVIntegrityError,
    PagedCachePool,
    block_checksums,
    default_row_fns,
)
from tpu_parallel_torch.serving.kv_disk import KVDiskStore
from tpu_parallel_torch.serving.kv_hierarchy import (
    MIGRATE_ALREADY_CACHED,
    MIGRATE_IMPORTED,
    MIGRATE_INCOMPATIBLE,
    MIGRATE_INTEGRITY,
    MIGRATE_NO_BLOCKS,
    MIGRATE_NO_KEY,
    MIGRATE_NO_PREFIX_CACHE,
    MIGRATE_NOT_PAGED,
    MIGRATE_WEIGHTS_VERSION,
    KVPrefixExport,
    RadixPrefixCache,
)
from tpu_parallel_torch.serving.metrics import (
    STALL_NONE,
    STALL_PREFILL,
    STALL_QUEUE_EMPTY,
    STALL_SPEC_VERIFY,
    ServingMetrics,
)
from tpu_parallel_torch.serving.prefix_cache import PrefixCache
from tpu_parallel_torch.serving.request import (
    CANCELLED,
    FAIL_INTEGRITY,
    FAILED,
    FINISHED,
    REJECT_CAPACITY,
    REJECTED,
    RUNNING,
    Request,
    RequestOutput,
    StreamEvent,
)
from tpu_parallel_torch.serving.sampling import filter_logits
from tpu_parallel_torch.serving.scheduler import FIFOScheduler, SchedulerConfig
from tpu_parallel_torch.serving.spec_decode import (
    Drafter,
    NGramDrafter,
    adapt_draft_len,
    adapt_draft_len_traced,
    draft_for_row,
    ngram_draft_tokens,
    verify_tokens,
)

# device-side integrity sentinel: a sampled "token" of this value means the
# row's logits held NaN/Inf; the host fails the request typed
# (FAIL_INTEGRITY) instead of streaming garbage.  -2 never collides with a
# real id (>= 0) or the parked/pad value (-1).
NON_FINITE_TOKEN = -2


def _synced_clock(clock: Callable[[], float], device) -> Callable[[], float]:
    """``clock`` read on every rank of the process group, as the maximum of
    the ranks' readings (one all-reduce per reading), so every rank's host
    decisions see the same time."""

    def now() -> float:
        t = torch.tensor([clock()], dtype=torch.float64, device=device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return float(t.item())

    return now


def _param_specs(model) -> Dict[str, Tuple[Optional[str], ...]]:
    """Each parameter's partition spec in torch's dims (the axis name at the
    dim its slices split, None elsewhere)."""
    from tpu_parallel_torch.parallel.fsdp import shard_info

    return {name: (shard_info(p).spec() if shard_info(p) is not None else (None,) * p.dim())
            for name, p in model.named_parameters()}


def sample_tokens(logits, generator: Optional[torch.Generator], temperature, top_k,
                  top_p) -> torch.Tensor:
    """Per-ROW sampling from [batch, vocab] logits with per-row knob tensors
    [batch]; returns int64 [batch].

    ``temperature == 0`` is the argmax (the first maximum); otherwise a
    Gumbel-max draw (``argmax(x - log E)``, E ~ Exp(1) from ``generator``)
    over :func:`~tpu_parallel_torch.serving.sampling.filter_logits` — a
    sample from the filtered softmax with no host sync, so it runs inside a
    CUDA graph.  A row whose logits hold any non-finite value returns
    :data:`NON_FINITE_TOKEN` instead of a token."""
    lf = logits.float()
    greedy = lf.argmax(dim=-1)
    x = filter_logits(lf, temperature, top_k, top_p)
    noise = torch.empty_like(x).exponential_(generator=generator)
    sampled = (x - noise.log()).argmax(dim=-1)
    out = torch.where(temperature > 0.0, sampled, greedy)
    finite = torch.isfinite(lf).all(dim=-1)
    return torch.where(finite, out, torch.full_like(out, NON_FINITE_TOKEN))


def _full_last_logits(model, hidden, last_idx=None) -> torch.Tensor:
    """The lm_head over ONE position per row: ``last_idx`` [batch] (each
    row's last real token in a right-padded prefill) or, when None, the
    final position.  Returns [batch, vocab] in the model's dtype."""
    if last_idx is None:
        h = hidden[:, -1]
    else:
        rows = torch.arange(hidden.shape[0], device=hidden.device)
        h = hidden[rows, last_idx.to(torch.long)]
    return model.lm_head(h)


def _prefill_core(model, prompt, positions, last_idx):
    """Batch-N pad-aware prefill into a fresh cache; returns each row's last
    REAL position's logits and the cache."""
    hidden, cache = prefill_step(model, prompt, positions)
    return _full_last_logits(model, hidden, last_idx), cache


def _extend_core(model, tokens, positions, last_idx, write_start, cache, table=None):
    """Continue a prefill into existing cache rows (chunked prefill, prefix
    remainder; with ``table``, any paged admission): tokens at global
    ``positions`` (pads -1) write at columns ``write_start + [0..T)``
    (through each row's block table when paged: the K/V land directly in
    the pool, and a row with an all -1 table drops every write).  Returns
    the chunk's last real logits."""
    hidden, cache = prefill_extend_step(model, cache, tokens, positions, write_start,
                                        block_table=table)
    return _full_last_logits(model, hidden, last_idx), cache


def _decode_core(model, tok, pos, widx, temperature, top_k, top_p, cache, generator,
                 table=None):
    """One engine tick over the slot pool: slot-indexed cache writes (and
    reads, through ``table`` when paged: the same math, so greedy output
    is bitwise equal across the layouts), per-slot sampling.  Returns the
    next tokens [n_slots]."""
    # a parked row may hold the sentinel (-2): its lookup wraps to a row of
    # the table as JAX's does (Embedding), so under MoE the row claims the
    # same expert capacity in both packages
    hidden, _ = decode_step(model, cache, tok, pos, write_index=widx, block_table=table)
    logits = _full_last_logits(model, hidden)
    return sample_tokens(logits, generator, temperature, top_k, top_p)


def _fused_decode_core(model, steps, tok, pos, widx, live, budget, eos, temp, topk, topp,
                       cache, generator, table=None):
    """``steps`` masked single-token decode steps: the fused tick's device
    body, with no host sync, so a CUDA graph can capture it.

    Each step is one :func:`_decode_core` tick on the same inputs (greedy
    tokens are bitwise equal to the per-step engine's).  A slot that
    finishes mid-tick (EOS, budget at zero, or the non-finite sentinel)
    drops out of ``live``: later steps park its writes at column
    ``seq_len``, its state stops and it emits -1.  ``eos`` is -1 for
    requests without an EOS id.  ``table`` (paged) is loop-invariant.

    Returns ``(block [steps, n_slots], counts [n_slots], (tok, pos, widx,
    live, budget))``: ``block`` holds each step's emitted token per slot,
    ``counts`` each slot's progress (live steps form a prefix, so the host
    delivers ``block[:counts[s], s]``)."""
    seq_len = model.config.seq_len
    emitted_steps = []
    for _ in range(steps):
        widx_eff = torch.where(live, widx, torch.full_like(widx, seq_len))
        nxt = _decode_core(model, tok, pos, widx_eff, temp, topk, topp, cache, generator, table)
        emitted = torch.where(live, nxt, torch.full_like(nxt, -1))
        budget = budget - live.to(budget.dtype)
        done = live & ((nxt == eos) | (budget <= 0) | (nxt == NON_FINITE_TOKEN))
        adv = live.to(pos.dtype)
        pos = pos + adv
        widx = widx + adv
        tok = torch.where(live, nxt, tok)
        live = live & ~done
        emitted_steps.append(emitted)
    block = torch.stack(emitted_steps)
    # the sentinel counts as progress (the host fails the request typed)
    counts = (block != -1).sum(dim=0)
    return block, counts, (tok, pos, widx, live, budget)


def _ragged_chunk_phase(model, tok, pos, widx, live, budget, eos, temp, topk, topp, ctoks,
                        clen, cstart, cfinal, cbudget, cache, generator, table=None):
    """The unified tick's PREFILL PHASE: one multi-token extend over the
    fixed ``[n_slots, chunk]`` block advances every mid-chunked-prefill
    slot by its next prompt chunk while every other row rides along as
    padding (positions -1, writes parked at column ``seq_len``).  Rows
    whose chunk COMPLETES their prompt (``cfinal``) activate in the same
    body: their first token samples from the chunk's last real position
    with the slot's own knobs and the slot state turns decode-live.

    ``ctoks`` [n, C] right-padded chunk tokens, ``clen`` [n] real tokens
    this tick (0 = row not prefilling), ``cstart`` [n] the slot's prefill
    depth (write offset), ``cfinal`` [n] whether this chunk ends the
    prompt, ``cbudget`` [n] ``max_new_tokens`` of activating rows.
    Returns ``(act_emit [n], (tok, pos, widx, live, budget))``;
    ``act_emit`` holds each activating row's first token, -1 elsewhere."""
    seq_len = model.config.seq_len
    iota = torch.arange(ctoks.shape[1], device=ctoks.device)[None, :]
    positions = torch.where(iota < clen[:, None], cstart[:, None] + iota,
                            torch.full_like(iota, -1))
    wstart = torch.where(clen > 0, cstart, torch.full_like(cstart, seq_len))
    logits, _ = _extend_core(model, ctoks, positions, (clen - 1).clamp(min=0), wstart, cache,
                             table)
    tok0 = sample_tokens(logits, generator, temp, topk, topp)
    act = cfinal & (clen > 0)
    nb = cbudget - 1
    done0 = (tok0 == eos) | (nb <= 0)
    new_pos = cstart + clen
    tok = torch.where(act, tok0, tok)
    pos = torch.where(act, new_pos, pos)
    widx = torch.where(act, new_pos, widx)
    budget = torch.where(act, nb, budget)
    live = torch.where(act, ~done0, live)
    act_emit = torch.where(act, tok0, torch.full_like(tok0, -1))
    return act_emit, (tok, pos, widx, live, budget)


def _unified_tick_core(model, steps, tok, pos, widx, live, budget, eos, temp, topk, topp,
                       ctoks, clen, cstart, cfinal, cbudget, cache, generator, table=None):
    """THE unified ragged tick: prefill-chunk slots consume their next
    chunk (with in-body final-chunk activation, :func:`_ragged_chunk_phase`)
    and decode slots run ``steps`` masked decode steps
    (:func:`_fused_decode_core`) in one body, so a tick that cost one
    extend per chunk slot plus the decode costs one replay.  Greedy output
    equals the per-phase engine's: every op is row- and position-parallel,
    so batch composition is invisible to each row.  Returns ``(act_emit
    [n], block [steps, n], counts [n], state)``."""
    act_emit, state = _ragged_chunk_phase(
        model, tok, pos, widx, live, budget, eos, temp, topk, topp, ctoks, clen, cstart,
        cfinal, cbudget, cache, generator, table)
    block, counts, state = _fused_decode_core(model, steps, *state, eos, temp, topk, topp,
                                              cache, generator, table)
    return act_emit, block, counts, state


def _verify_core(model, tok, drafts, draft_len, pos, widx, temperature, top_k, top_p, cache,
                 generator, table=None, sampled: Optional[bool] = None):
    """One SPECULATIVE tick over the slot pool: each row feeds its current
    token plus its (padded) draft block through one multi-token forward
    (:func:`~tpu_parallel_torch.models.generate.verify_step`), scores every
    offset, and the per-row acceptance rule
    (:func:`~tpu_parallel_torch.serving.spec_decode.verify_tokens`) keeps
    the longest exact prefix + one bonus token.

    Offsets beyond a row's ``draft_len`` carry position -1 (their columns
    are invalidated, never attended) and their logits are unreachable
    (``accepted <= draft_len``).  Parked rows (``widx == seq_len``) drop
    every write, as on the plain decode tick.  ``sampled``: whether any row
    samples (:func:`verify_tokens`).  Returns ``(tokens [n, K+1], accepted
    [n])``; a row whose reachable logits hold a non-finite value emits
    :data:`NON_FINITE_TOKEN` at every offset."""
    k = drafts.shape[1]
    tokens = torch.cat([tok[:, None], drafts], dim=1)
    offs = torch.arange(k + 1, device=tok.device)[None, :]
    reach = offs <= draft_len[:, None]
    positions = torch.where(reach, pos[:, None] + offs, torch.full_like(offs, -1))
    # a parked row may hold the sentinel (-2), which wraps as JAX's lookup
    # does (Embedding); a drafter's id past the vocabulary is clamped into
    # the table (JAX's lookup reads NaN there)
    hidden, _ = verify_step(model, cache, tokens.clamp(max=model.config.vocab_size - 1),
                            positions, widx, block_table=table)
    logits = model.lm_head(hidden)
    out_tokens, accepted = verify_tokens(drafts, draft_len, logits, generator, temperature,
                                         top_k, top_p, sampled=sampled)
    # argmax over NaN logits returns a valid-looking token: screen every
    # offset the acceptance rule can reach (pad offsets carry garbage by
    # design and must not trip it)
    finite = (torch.isfinite(logits).all(dim=-1) | ~reach).all(dim=1)
    out_tokens = torch.where(finite[:, None], out_tokens,
                             torch.full_like(out_tokens, NON_FINITE_TOKEN))
    return out_tokens, accepted


def _fused_spec_core(model, steps, k, max_ngram, min_ngram, adaptive, sampled, tok, pos, widx,
                     live, budget, keff, hist, eos, temp, topk, topp, kmax, cache, generator,
                     table=None):
    """``steps`` speculative draft-verify-accept blocks in one body, with no
    host sync: the fused spec tick.  Each block is the per-step
    :func:`_verify_core` tick on the same inputs, with the two host jobs
    done on the device:

    - drafting: block ``t+1``'s context holds block ``t``'s accepted
      tokens, so the body drafts from the per-slot token history ``hist``
      [n, seq_len + 1] (column ``seq_len`` is scratch) with
      :func:`~tpu_parallel_torch.serving.spec_decode.ngram_draft_tokens`,
      the n-gram drafter's tensor twin (so the tokens equal the per-step
      engine's; the engine refuses to fuse any other drafter).
    - adaptation: ``keff`` grows and shrinks per block by the shared law
      (``adaptive``).

    A block delivers ``accepted + 1`` tokens cut at the first EOS; a slot
    that finishes drops out of ``live`` (writes parked at ``seq_len``).
    ``hist`` is updated in place.  Returns ``(blocks [steps, n, K+1],
    counts [steps, n], drafted [steps, n], accepted [steps, n], (tok, pos,
    widx, live, budget, keff))``; ``counts`` is each block's DELIVERED
    token count per slot (0 = slot not live that block)."""
    seq_len = model.config.seq_len
    dev = tok.device
    offs = torch.arange(k + 1, device=dev)[None, :]
    rows = torch.arange(tok.shape[0], device=dev)
    parked = torch.full_like(pos, seq_len)
    zero = torch.zeros_like(pos)
    outs = []
    for _ in range(steps):
        cap = torch.minimum(torch.minimum(keff, seq_len - 1 - widx), budget - 1)
        cap = torch.where(live, cap.clamp(min=0), zero)
        drafts, dlen = ngram_draft_tokens(hist[:, :seq_len], pos + 1, cap, k, max_ngram,
                                          min_ngram)
        dlen = torch.where(live, dlen, zero)
        widx_eff = torch.where(live, widx, parked)
        out_tokens, accepted = _verify_core(model, tok, drafts, dlen, pos, widx_eff, temp, topk,
                                            topp, cache, generator, table, sampled)
        finite = out_tokens[:, 0] != NON_FINITE_TOKEN
        # delivery, the per-step host loop's law: accepted + 1 tokens, cut
        # at the first EOS; a length finish only lands on the block's last
        # token (the draft cap keeps blocks inside the budget)
        is_eos = (out_tokens == eos[:, None]) & (offs <= accepted[:, None])
        any_eos = is_eos.any(dim=1)
        eos_at = torch.where(any_eos, is_eos.to(torch.uint8).argmax(dim=1),
                             torch.full_like(accepted, k + 1))
        e = torch.where(live, torch.minimum(accepted + 1, eos_at + 1), zero)
        emitted = torch.where(offs < e[:, None], out_tokens, torch.full_like(out_tokens, -1))
        new_budget = budget - e
        done = live & (any_eos | (new_budget <= 0) | ~finite)
        # the history gains the block's accepted + bonus tokens at columns
        # pos + 1 + j (dead rows' targets go to the scratch column)
        for j in range(k + 1):
            col = torch.where(live & (accepted >= j), pos + 1 + j, parked)
            hist.index_put_((rows, col), out_tokens[:, j])
        adv = torch.where(live, accepted + 1, zero)
        pos = pos + adv
        widx = widx + adv
        tok = torch.where(live, out_tokens.gather(1, accepted[:, None])[:, 0], tok)
        budget = torch.where(live, new_budget, budget)
        new_live = live & ~done
        if adaptive:
            keff = torch.where(new_live & (kmax > 0),
                               adapt_draft_len_traced(keff, dlen, accepted, kmax), keff)
        live = new_live
        outs.append((emitted, e, dlen, accepted))
    blocks, counts, drafted, accepts = (torch.stack(x) for x in zip(*outs))
    return blocks, counts, drafted, accepts, (tok, pos, widx, live, budget, keff)


def _unified_spec_core(model, steps, k, max_ngram, min_ngram, adaptive, sampled, tok, pos, widx,
                       live, budget, keff, hist, eos, temp, topk, topp, kmax, ctoks, clen,
                       cstart, cfinal, cbudget, cache, generator, table=None):
    """The unified tick's speculative form: the chunk phase of
    :func:`_unified_tick_core` in front (an activating row's first token
    lands in ``hist`` so its first block can draft from it, and its draft
    length starts at its cap), then ``steps`` fused draft-verify blocks
    (:func:`_fused_spec_core`).  Returns ``(act_emit [n], blocks, counts,
    drafted, accepted, state)``."""
    seq_len = model.config.seq_len
    act_emit, (tok, pos, widx, live, budget) = _ragged_chunk_phase(
        model, tok, pos, widx, live, budget, eos, temp, topk, topp, ctoks, clen, cstart, cfinal,
        cbudget, cache, generator, table)
    act = act_emit >= 0
    rows = torch.arange(tok.shape[0], device=tok.device)
    col = torch.where(act, cstart + clen, torch.full_like(cstart, seq_len))
    hist.index_put_((rows, col), act_emit.clamp(min=0))
    keff = torch.where(act, kmax, keff)
    blocks, counts, drafted, accepted, state = _fused_spec_core(
        model, steps, k, max_ngram, min_ngram, adaptive, sampled, tok, pos, widx, live, budget,
        keff, hist, eos, temp, topk, topp, kmax, cache, generator, table)
    return act_emit, blocks, counts, drafted, accepted, state


def validate_same_shapes(old, new) -> None:
    """Raise ``ValueError`` unless the state dict ``new`` matches ``old``
    name for name in shape and dtype: the precondition for a rebind that
    keeps every address (and captured graph) valid.  THE one check both
    :meth:`ServingEngine.rebind_params` and the cluster's ``begin_swap``
    typed up-front refusal run, so they can never drift apart."""
    if set(old) != set(new):
        diff = sorted(set(old) ^ set(new))
        raise ValueError(f"weight tree structure differs: names {diff[:3]}")
    for name, a in old.items():
        b = new[name]
        if (
            tuple(getattr(a, "shape", ())) != tuple(getattr(b, "shape", ()))
            or getattr(a, "dtype", None) != getattr(b, "dtype", None)
        ):
            raise ValueError(
                f"leaf {name}: {tuple(getattr(b, 'shape', ()))}/{getattr(b, 'dtype', None)}"
                f" != served {tuple(a.shape)}/{a.dtype}"
            )


def default_prefill_buckets(seq_len: int, start: int = 32) -> Tuple[int, ...]:
    """Geometric bucket set ``(32, 64, ..., seq_len)``; ``seq_len`` is always
    the last bucket so every admissible prompt fits one."""
    buckets, b = [], min(start, seq_len)
    while b < seq_len:
        buckets.append(b)
        b *= 2
    buckets.append(seq_len)
    return tuple(buckets)


class _ChunkState:
    """An in-flight chunked prefill: the request owns its slot, the prompt
    extends one chunk per tick, activation happens on the final chunk."""

    __slots__ = ("out", "offset")

    def __init__(self, out: RequestOutput, offset: int):
        self.out = out
        self.offset = offset


class _PendingTick:
    """One tick between :meth:`ServingEngine.launch` and
    :meth:`ServingEngine.collect`: the launched work's unsynced result
    (``payload``) and the host bookkeeping collect needs."""

    __slots__ = (
        "kind", "start", "t0", "tick_span", "events", "admitted",
        "chunks_advanced", "chunk_tokens", "chunk_spans", "active_tokens",
        "entering", "finals", "payload", "overlapped",
    )

    def __init__(self, start: float):
        self.kind = "idle"
        self.start = start
        self.t0 = 0.0
        self.tick_span = None
        self.events: List[StreamEvent] = []
        self.admitted: List[RequestOutput] = []
        self.chunks_advanced = 0
        self.chunk_tokens = 0
        self.chunk_spans: List[tuple] = []
        self.active_tokens = 0
        self.entering: Tuple[int, ...] = ()
        # (slot, output, prompt length) of chunks that complete their
        # prompt inside this unified tick
        self.finals: List[tuple] = []
        self.payload = None
        self.overlapped = False


class ServingEngine:
    """In-process continuous-batching engine over one ``GPTLM``, which
    holds the weights and sets the device (``"cuda"`` unless the model was
    built with ``device="cpu"``).

    ``step()`` runs one scheduling + decode tick and returns its
    :class:`StreamEvent`s; ``run()`` ticks until idle.  ``add_request`` is
    non-blocking: the returned :class:`RequestOutput` fills in as ticks
    run.  ``n_slots`` fixes the slot count; ``scheduler`` takes a
    :class:`SchedulerConfig` or a ready :class:`FIFOScheduler`; ``clock``
    is injectable; ``rng`` is a ``torch.Generator`` on the model's device
    (default: seeded with 0).

    Prefill knobs: ``prefill_buckets`` (``"auto"`` = 32, 64, ..., seq_len;
    a tuple; or None for batch-1 exact-length prefill), ``prefill_batch``
    (rows every batched prefill pads to; default the scheduler's
    ``max_prefills_per_tick``), ``prefill_chunk_tokens`` (chunk size for
    longer prompts; None = monolithic), ``prefix_cache_size`` (LRU entries
    of bucket-aligned prefixes; 0 = off; needs buckets).

    KV layout: ``kv_block_tokens`` None/0 keeps the fixed ``n_slots x
    seq_len`` pool; an int (dividing ``seq_len``) or ``"auto"`` (the gcd
    of ``seq_len``, 32 and every bucket, so bucket-aligned prefixes end on
    block boundaries) pages it into ``kv_pool_blocks`` blocks (default
    ``n_slots * seq_len / kv_block_tokens``, the fixed pool's size).

    KV hierarchy (paged only): ``kv_radix_cache`` replaces the aligned-LRU
    prefix cache with the radix tree, ``prefix_cache_size`` then bounding
    the device blocks it holds (hits are whole blocks, so the
    copy-on-write reserve drops to zero); ``kv_host_blocks`` (implies
    ``kv_radix_cache``) is the host-RAM tier's capacity in blocks;
    ``kv_disk_dir`` with ``kv_disk_blocks`` (together, and only over a
    host tier) is the disk tier under it.

    ``decode_steps_per_tick``: T > 1 (``"auto"`` = 8) runs T masked decode
    steps per tick with the slot state on the device, one device-to-host
    sync per T tokens; 1 is the per-step engine.  ``unified_tick``
    (``"auto"`` = on whenever T > 1, as in JAX; False keeps the
    per-phase advance-then-decode tick, the parity baseline; True needs
    T > 1) folds chunked prefills into the tick.  ``graph_captures``
    counts CUDA graph captures (one per tick body on a CUDA device).

    Speculative decoding: ``draft_tokens`` K > 0 verifies up to K drafted
    tokens per slot per step (a request's own ``draft_tokens`` may lower
    its cap); ``drafter`` (default :class:`NGramDrafter`) proposes them;
    ``spec_adaptive`` grows and shrinks each slot's draft length with its
    acceptance; ``spec_check_invariants`` asserts the aligned cache layout
    after every block (a debug aid, one device-to-host copy).  With drafts,
    ``decode_steps_per_tick="auto"`` is 1 (host drafting, any drafter); an
    explicit T > 1 fuses T blocks per tick with the n-gram drafter only.

    Mesh: ``mesh`` is the one the model was built on (see the module
    docstring).  ``param_specs`` keeps JAX's signature: the layout comes
    from the model's own parameters, so the engine only checks that a
    given ``param_specs`` equals it and uses it for nothing else.

    Telemetry: ``tracer`` (default the no-op ``NULL_TRACER``) records
    request lifecycle spans; ``metrics`` / ``registry`` back the
    counters, gauges and histograms (:class:`ServingMetrics`).
    """

    def __init__(
        self,
        model,
        n_slots: int = 8,
        scheduler: Union[SchedulerConfig, FIFOScheduler, None] = None,
        mesh=None,
        param_specs=None,
        rng: Optional[torch.Generator] = None,
        metrics: Optional[ServingMetrics] = None,
        tracer: Optional[Tracer] = None,
        registry: Optional[MetricRegistry] = None,
        clock: Callable[[], float] = time.monotonic,
        prefill_buckets: Union[str, Sequence[int], None] = "auto",
        prefill_batch: Optional[int] = None,
        prefill_chunk_tokens: Optional[int] = None,
        prefix_cache_size: int = 0,
        kv_block_tokens: Union[int, str, None] = None,
        kv_pool_blocks: Optional[int] = None,
        kv_radix_cache: bool = False,
        kv_host_blocks: int = 0,
        kv_disk_dir: Optional[str] = None,
        kv_disk_blocks: int = 0,
        decode_steps_per_tick: Union[int, str] = "auto",
        unified_tick: Union[str, bool] = "auto",
        draft_tokens: int = 0,
        drafter=None,
        spec_adaptive: bool = True,
        spec_check_invariants: bool = False,
    ):
        cfg = model.config
        if getattr(model, "pipe", None) is not None or getattr(cfg, "pipe_size", 1) > 1:
            raise NotImplementedError(
                "slot-indexed cache writes under pipeline parallelism "
                "(the decode ring's per-stage caches would need the "
                "write-slot table as a ring extra — serve pipe meshes "
                "through generate_sharded, not the serving engine)"
            )
        if cfg.positional == "relative":
            # the shared T5 bias table assumes row-uniform positions; a slot
            # pool's rows sit at different depths
            raise NotImplementedError(
                "the serving engine does not run positional='relative' "
                "models (per-row slot depths break the shared bias "
                "table) — serve those through generate()"
            )
        if mesh is not None and mesh is not getattr(model, "mesh", None):
            raise ValueError("mesh serving needs the mesh the model was built on "
                             "(GPTLM(config, mesh=mesh))")
        if param_specs is not None and param_specs != _param_specs(model):
            raise ValueError("param_specs differ from the model's own layout")
        if unified_tick not in ("auto", True, False):
            raise ValueError(f"unified_tick={unified_tick!r}")
        self.model = model
        self.mesh = mesh
        self.device = model.device
        self.weights_version = "initial"
        if mesh is not None:
            clock = _synced_clock(clock, self.device)
        self.clock = clock
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.metrics = metrics if metrics is not None else ServingMetrics(registry=registry)
        self.registry = self.metrics.registry
        self.integrity_trips = 0
        if isinstance(scheduler, FIFOScheduler):
            self.scheduler = scheduler
            if self.scheduler.registry is None:
                self.scheduler.registry = self.registry
            if mesh is not None:
                self.scheduler.clock = clock
        else:
            self.scheduler = FIFOScheduler(scheduler, clock=clock, registry=self.registry)
        self._queue_spans: Dict[str, object] = {}
        if rng is None:
            rng = torch.Generator(device=self.device).manual_seed(0)
        elif rng.device.type != self.device.type or rng.device.index not in (
                None, self.device.index):
            raise ValueError(f"rng is on {rng.device}, the model on {self.device}")
        self._gen = rng

        if prefill_buckets == "auto":
            self._buckets: Optional[Tuple[int, ...]] = default_prefill_buckets(cfg.seq_len)
        elif prefill_buckets:
            bs = tuple(sorted(int(b) for b in prefill_buckets))
            if bs[0] < 1 or bs[-1] > cfg.seq_len:
                raise ValueError(f"prefill_buckets={bs} outside [1, seq_len={cfg.seq_len}]")
            if bs[-1] < cfg.seq_len:
                bs = bs + (cfg.seq_len,)  # every admissible prompt must fit
            self._buckets = bs
        else:
            self._buckets = None
        # block-paged KV cache: kv_block_tokens > 0 (or "auto") swaps the
        # fixed n_slots x seq_len pool for a pool of kv_pool_blocks blocks
        # addressed through per-slot block tables
        self._paged = kv_block_tokens not in (None, 0)
        if self._paged:
            if mesh is not None:
                raise NotImplementedError(
                    "paged KV cache under a mesh (build_sharded_serving has no block-table "
                    "plumbing) — mesh serving keeps the fixed-slot pool"
                )
            if kv_block_tokens == "auto":
                # the bucket quantum: bucket-aligned prefix keys always
                # land on block boundaries, so shared blocks need no trim
                bt = math.gcd(cfg.seq_len, 32)
                for b in self._buckets or ():
                    bt = math.gcd(bt, int(b))
            else:
                bt = int(kv_block_tokens)
                if bt < 1:
                    raise ValueError(f"kv_block_tokens={bt} < 1")
                if cfg.seq_len % bt != 0:
                    raise ValueError(f"kv_block_tokens={bt} must divide seq_len={cfg.seq_len}")
            n_blocks = (int(kv_pool_blocks) if kv_pool_blocks is not None
                        else n_slots * (cfg.seq_len // bt))
            if n_blocks < 1:
                raise ValueError(f"kv_pool_blocks={n_blocks} < 1")
        elif kv_pool_blocks is not None:
            raise ValueError("kv_pool_blocks needs kv_block_tokens")
        if prefill_chunk_tokens is not None and prefill_chunk_tokens < 1:
            raise ValueError(f"prefill_chunk_tokens={prefill_chunk_tokens} < 1")
        self._chunk_tokens = prefill_chunk_tokens
        if prefix_cache_size > 0 and self._buckets is None:
            raise ValueError(
                "prefix_cache_size > 0 requires prefill bucketing (prefix keys are "
                "bucket-aligned)"
            )
        # radix hierarchy (kv_hierarchy.py): swaps the aligned-LRU cache for
        # the token-level radix tree (+ host and disk tiers) on the paged
        # path; built after the pool (it holds pool references), so only
        # validated here
        if kv_host_blocks < 0:
            raise ValueError(f"kv_host_blocks={kv_host_blocks} < 0")
        # the disk tier sits UNDER the host tier: both knobs travel
        # together, and the host tier must exist (disk spills are cold host
        # evictions, so a disk tier without one would never fill)
        if kv_disk_blocks < 0:
            raise ValueError(f"kv_disk_blocks={kv_disk_blocks} < 0")
        if (kv_disk_dir is None) != (kv_disk_blocks == 0):
            raise ValueError("kv_disk_dir and kv_disk_blocks > 0 travel together")
        if kv_disk_dir is not None and kv_host_blocks < 1:
            raise ValueError(
                "kv_disk_dir needs kv_host_blocks > 0 (the disk tier sits UNDER the host "
                "offload tier)"
            )
        self._kv_disk_dir = kv_disk_dir
        self._kv_disk_blocks = int(kv_disk_blocks)
        self._radix_requested = bool(kv_radix_cache) or kv_host_blocks > 0
        self._kv_host_blocks = int(kv_host_blocks)
        self._radix: Optional[RadixPrefixCache] = None
        if self._radix_requested:
            if not self._paged:
                raise ValueError(
                    "kv_radix_cache / kv_host_blocks need the block-paged pool "
                    "(kv_block_tokens > 0): the radix tree indexes physical blocks"
                )
            if prefix_cache_size < 1:
                raise ValueError(
                    "kv_radix_cache needs prefix_cache_size > 0 (the radix tree's resident "
                    "device-block budget)"
                )
        # the aligned-LRU cache; the radix tree takes its place once the pool
        # exists
        self._prefix = (
            PrefixCache(prefix_cache_size,
                        # paged entries hold refcounted block ids: eviction
                        # hands the references back to the allocator
                        on_evict=self._release_prefix_entry if self._paged else None)
            if prefix_cache_size > 0 and not self._radix_requested else None
        )
        # copy-on-write admission headroom: with buckets NOT aligned to
        # the block size, stored prefixes end mid-block and sharers'
        # writes copy-on-write, each claiming a block the plain
        # ceil(total / bt) estimate cannot see.  One block per non-aligned
        # bucket plus one for a mid-block hit tail bounds one slot's COW
        # events (zero under the "auto" quantum, and under the radix tree,
        # whose matches and stores are whole blocks).
        self._cow_reserve = 0
        if self._paged and self._prefix is not None:
            unaligned = sum(1 for b in self._buckets if b % bt != 0)
            self._cow_reserve = (1 + unaligned) if unaligned else 0
        self._prefill_batch = (
            prefill_batch if prefill_batch is not None
            else self.scheduler.config.max_prefills_per_tick
        )
        if self._prefill_batch < 1:
            raise ValueError(f"prefill_batch={self._prefill_batch} < 1")
        self._chunking: Dict[int, _ChunkState] = {}
        self._prefill_shapes: set = set()

        # speculative decode: draft_tokens > 0 turns the decode tick into
        # draft-verify blocks of width draft_tokens + 1 (per-slot draft
        # lengths vary underneath through -1-position padding; the verify
        # shape never changes)
        if draft_tokens < 0:
            raise ValueError(f"draft_tokens={draft_tokens} < 0")
        self._spec_width = int(draft_tokens)
        self._drafter: Drafter = drafter if drafter is not None else NGramDrafter()
        self._spec_adaptive = bool(spec_adaptive)
        self._spec_check = bool(spec_check_invariants)
        # "auto" = 8 steps plain, 1 speculative; an explicit T > 1 with
        # drafts fuses T draft-verify blocks per tick, drafting on the
        # device with the n-gram drafter's twin: a custom drafter's host
        # state is invisible there, so it refuses
        if decode_steps_per_tick == "auto":
            fused = 1 if (draft_tokens > 0 or mesh is not None) else 8
        else:
            fused = int(decode_steps_per_tick)
            if fused < 1:
                raise ValueError(f"decode_steps_per_tick={decode_steps_per_tick} < 1")
            if fused > 1 and mesh is not None:
                raise NotImplementedError(
                    "decode_steps_per_tick > 1 under a mesh (build_sharded_serving exposes no "
                    "buffer donation) — mesh serving decodes per-step"
                )
            if fused > 1 and draft_tokens > 0 and type(self._drafter) is not NGramDrafter:
                raise NotImplementedError(
                    f"decode_steps_per_tick={fused} with draft_tokens > 0 fuses the draft-verify "
                    "blocks of a tick, drafting on the device with the n-gram drafter's tensor "
                    f"twin; the drafter {type(self._drafter).__name__} keeps host state that "
                    "cannot run there: keep decode_steps_per_tick=1 for it"
                )
        if unified_tick is True and fused < 2:
            raise ValueError(
                "unified_tick=True needs decode_steps_per_tick > 1 (the unified tick IS "
                "the fused tick with the ragged chunk phase folded in)"
            )
        self._fused_steps = fused
        self._spec_fused = fused > 1 and draft_tokens > 0
        self._unified = (fused > 1 and mesh is None if unified_tick == "auto"
                         else bool(unified_tick))
        if self._paged:
            self.pool: Union[CachePool, PagedCachePool] = PagedCachePool(
                model, n_slots, block_tokens=bt, n_blocks=n_blocks)
            if self._radix_requested:
                # the radix hierarchy takes the aligned-LRU cache's place:
                # the same lookup / store / evict / counter surface, so
                # admission, the block-pressure valve and the metrics are
                # layout-blind
                disk_store = None
                if self._kv_disk_dir is not None:
                    disk_store = KVDiskStore(self._kv_disk_dir, self.clock,
                                             capacity_blocks=self._kv_disk_blocks)
                self._radix = RadixPrefixCache(
                    self.pool, max_device_blocks=prefix_cache_size,
                    host_capacity_blocks=self._kv_host_blocks, disk_store=disk_store,
                    weights_version=self.weights_version,
                )
                self._prefix = self._radix
        else:
            self.pool = CachePool(model, n_slots, row_fns=default_row_fns())
        n = n_slots
        self._tok = np.zeros(n, np.int64)
        self._pos = np.zeros(n, np.int64)
        # inactive rows aim their decode writes at column seq_len, which the
        # cache drops, so a free or mid-chunked-prefill row is never touched
        self._widx = np.full(n, cfg.seq_len, np.int64)
        self._temp = np.zeros(n, np.float32)
        self._topk = np.zeros(n, np.int64)
        self._topp = np.zeros(n, np.float32)
        self._active = np.zeros(n, bool)
        self._slot_out: List[Optional[RequestOutput]] = [None] * n
        # per-slot speculative state: the request's draft cap and the
        # acceptance-adaptive draft length (<= cap)
        self._spec_max = np.zeros(n, np.int64)
        self._spec_k = np.zeros(n, np.int64)

        dev = self.device
        # the device copy of the pool's block table, at a fixed address the
        # captured graphs read; rewritten in place when table_version moves
        self._dev_table = None
        self._table_version = -1
        if self._paged:
            self._dev_table = torch.full((n, self.pool.max_blocks), -1, dtype=torch.long,
                                         device=dev)
        # the fused tick's device-resident slot state and knobs, at fixed
        # addresses: (tok, pos, widx, live, budget) and (eos, temp, topk,
        # topp); the host rewrites them in place after admissions/releases
        self._state_dirty = True
        # the captured tick bodies by kind ("fused", "unified", and the spec
        # bodies "spec_fused", "spec_unified", each with a "_sampled" twin)
        self._graphs: Dict[str, "torch.cuda.CUDAGraph"] = {}
        self._use_graphs = dev.type == "cuda"
        self.graph_captures = 0
        if fused > 1:
            zeros = lambda dtype: torch.zeros(n, dtype=dtype, device=dev)
            self._dev_state = (zeros(torch.long), zeros(torch.long), zeros(torch.long),
                               zeros(torch.bool), zeros(torch.long))
            self._dev_knobs = (zeros(torch.long), zeros(torch.float32), zeros(torch.long),
                               zeros(torch.float32))
            # rows [0, T): the tick's token block; row T: counts; row T + 1:
            # the unified tick's activation tokens
            out_shape = (fused + 2, n)
            if self._spec_fused:
                # + the adaptive draft length and the token history (column
                # seq_len is scratch), rewritten only at admission; knobs +
                # each slot's draft cap.  Output [T + 1, n, K + 4]: per
                # block the K + 1 emitted tokens, the delivered count, the
                # drafted and the accepted count; row T, entry 0: the
                # activation tokens
                self._dev_state += (zeros(torch.long), torch.zeros(
                    n, cfg.seq_len + 1, dtype=torch.long, device=dev))
                self._dev_knobs += (zeros(torch.long),)
                out_shape = (fused + 1, n, self._spec_width + 4)
            # two host buffers the output is copied to (a launch-ahead must
            # not overwrite the tick still waiting for its collect)
            self._dev_out = torch.zeros(out_shape, dtype=torch.long, device=dev)
            pin = dev.type == "cuda"
            self._host_out = [torch.zeros(out_shape, dtype=torch.long, pin_memory=pin)
                              for _ in range(2)]
            self._host_turn = 0
            if self._unified and self._chunk_tokens is not None:
                # the unified tick's chunk operands (ctoks, clen, cstart,
                # cfinal, cbudget), filled in place every chunk tick
                self._dev_chunk = (
                    torch.zeros(n, self._chunk_tokens, dtype=torch.long, device=dev),
                    zeros(torch.long), zeros(torch.long), zeros(torch.bool), zeros(torch.long))

    # -- submission --------------------------------------------------------

    def add_request(self, request: Request, requeue: bool = False,
                    arrival_time: Optional[float] = None) -> RequestOutput:
        """Submit; returns the live output record (status REJECTED with a
        typed ``finish_reason``, ``capacity`` / ``queue_full`` /
        ``draining``, when the prompt cannot fit or admission refuses).
        ``requeue=True`` bypasses the drain gate (relocated work);
        ``arrival_time`` keeps an original arrival across retries."""
        out = RequestOutput(
            request, arrival_time=arrival_time if arrival_time is not None else self.clock()
        )
        seq_len = self.model.config.seq_len
        total = len(request.prompt) + request.max_new_tokens
        if total > seq_len:
            out.status = REJECTED
            out.finish_reason = REJECT_CAPACITY
            out.detail = (
                f"prompt ({len(request.prompt)}) + max_new_tokens "
                f"({request.max_new_tokens}) exceeds seq_len ({seq_len})"
            )
            self.metrics.record_rejected()
            return out
        if self._paged:
            # a pool smaller than one request's worst case could never
            # admit it: a typed reject (transient exhaustion instead
            # queues, the block gate holding the head until blocks free)
            need = self.pool.blocks_needed(total) + self._cow_reserve
            if need > self.pool.n_blocks:
                out.status = REJECTED
                out.finish_reason = REJECT_CAPACITY
                out.detail = (
                    f"request needs {need} KV blocks ({total} tokens at "
                    f"{self.pool.block_tokens}/block"
                    + (f" + {self._cow_reserve} copy-on-write reserve" if self._cow_reserve
                       else "")
                    + f") but the pool holds {self.pool.n_blocks}"
                )
                self.metrics.record_rejected()
                return out
        verdict = self.scheduler.submit(out, requeue=requeue)
        if not verdict:
            out.status = REJECTED
            out.finish_reason = verdict.reason
            self.metrics.record_rejected()
            return out
        if self.tracer.enabled:
            rid = request.request_id
            self._queue_spans[rid] = self.tracer.start_async(
                "queue", track="scheduler", async_id=rid, request_id=rid
            )
        return out

    # -- lifecycle control (cancellation / drain) --------------------------

    def cancel(self, request_id: str, reason: str = "cancelled") -> bool:
        """Cancel a request wherever it is: queued (pulled from the
        scheduler) or in a slot (released, mid-chunked-prefill included).
        Sends a terminal tokenless StreamEvent; False when the request is
        unknown or already terminal."""
        out = self.scheduler.remove(request_id)
        slot: Optional[int] = None
        if out is None:
            for i, candidate in enumerate(self._slot_out):
                if candidate is not None and candidate.request.request_id == request_id:
                    slot, out = i, candidate
                    break
            if out is None:
                return False
            self.release_slot(slot)
        now = self.clock()
        span = self._queue_spans.pop(request_id, None)
        if span is not None:
            span.finish(cancelled=True)
        out.status = CANCELLED
        out.finish_reason = reason
        out.finish_time = now
        self.metrics.record_cancelled()
        if self.tracer.enabled:
            track = "scheduler" if slot is None else f"slot {slot}"
            self.tracer.instant("cancel", track=track, request_id=request_id, reason=reason)
        event = StreamEvent(request_id=request_id, token=-1, index=-1, finished=True,
                            finish_reason=reason)
        if out.request.on_token is not None:
            out.request.on_token(event)
        return True

    def release_slot(self, slot: int) -> None:
        """Free ``slot`` without delivering anything: drop any in-flight
        chunked prefill, park the row's writes at column seq_len, return the
        slot to the pool.  The retirement and cancellation path."""
        self._chunking.pop(slot, None)
        self._active[slot] = False
        self._slot_out[slot] = None
        self._widx[slot] = self.model.config.seq_len
        self._state_dirty = True
        self.pool.release(slot)

    def begin_drain(self) -> None:
        """Graceful-drain gate: new submissions reject with ``draining``;
        queued and in-flight work runs to completion."""
        self.scheduler.begin_drain()

    @property
    def draining(self) -> bool:
        return self.scheduler.draining

    @property
    def in_flight(self) -> int:
        """Requests holding a slot: decoding plus mid-chunked-prefill."""
        return int(self._active.sum()) + len(self._chunking)

    @property
    def pending_prefill_tokens(self) -> int:
        """Prompt tokens still to prefill: queued prompts plus the unwritten
        remainders of in-flight chunked prefills."""
        chunk_rest = sum(len(st.out.request.prompt) - st.offset
                         for st in self._chunking.values())
        return self.scheduler.pending_prefill_tokens + chunk_rest

    # -- the tick ----------------------------------------------------------

    def step(self) -> List[StreamEvent]:
        """One engine tick: expire stale queue entries, advance in-flight
        chunked prefills (one chunk each: inside the tick's body under the
        unified tick, else one extend per slot first), admit into free
        slots (one same-bucket group, one batched prefill), one decode
        tick over the pool (T fused steps or one step), retire finished
        slots.  ``collect(launch())``; returns this tick's events."""
        return self.collect(self.launch())

    @torch.no_grad()
    def launch(self, ahead: bool = False) -> _PendingTick:
        """The tick's host-to-device half: expire, advance chunks, admit, and
        launch the decode work WITHOUT syncing on its result.  ``ahead``
        marks a launch made while the previous tick is still uncollected
        (only on a pure-decode fused tick, :meth:`_can_launch_ahead`); the
        paged write window then covers two ticks, since the host mirrors
        lag the device by one."""
        now = self.clock()
        p = _PendingTick(now)
        p.overlapped = ahead
        if self.tracer.enabled:
            p.tick_span = self.tracer.span("tick", track="scheduler", tick=self.metrics.ticks)
        self._expire_queue(now, p.events)
        unified = self.unified_tick
        if not unified:
            # per-phase: chunked prefills first, one extend per slot; a
            # chunk finishing this tick decodes this tick
            p.chunks_advanced = len(self._chunking)
            for slot in sorted(self._chunking):
                p.events.extend(self._advance_chunk(slot))
        bucket_key = (
            self._admission_key
            if (self._buckets is not None or self._chunk_tokens is not None)
            else None
        )
        p.admitted = self.scheduler.schedule(
            self.pool.n_free, now, bucket_key=bucket_key,
            can_admit=self._block_gate() if self._paged else None)
        p.events.extend(self._admit_batch(p.admitted))
        if unified:
            # chunk slots (newly started ones included) ride THIS tick's
            # body: the per-phase engine's chunk-per-tick cadence
            p.chunks_advanced = len(self._chunking)
        self._launch_decode(p)
        # tokens resident during this tick's decode (the denominator of
        # kv_bytes_per_active_token), taken before delivery retires slots
        p.active_tokens = int(self._pos[self._active].sum()) + sum(
            st.offset for st in self._chunking.values()
        ) + sum(plen for (_, _, plen) in p.finals)
        return p

    def _expire_queue(self, now: float, events: List[StreamEvent]) -> None:
        for out in self.scheduler.expire(now):
            # a terminal tokenless event: expiry is asynchronous, so stream
            # consumers need it or they wait forever
            out.finish_reason = "max_wait"
            out.finish_time = now
            rid = out.request.request_id
            span = self._queue_spans.pop(rid, None)
            if span is not None:
                span.finish(expired=True)
            event = StreamEvent(request_id=rid, token=-1, index=-1, finished=True,
                                finish_reason="max_wait")
            if out.request.on_token is not None:
                out.request.on_token(event)
            events.append(event)
            self.metrics.record_expired()

    def _launch_decode(self, p: _PendingTick) -> None:
        unified_chunks = bool(self.unified_tick and self._chunking)
        if not self._active.any() and not unified_chunks:
            return
        p.t0 = self.tracer.now()
        p.entering = tuple(int(s) for s in np.nonzero(self._active)[0])
        if self._spec_fused:
            self._launch_spec_fused(p, unified_chunks)
        elif self._spec_width > 0:
            self._launch_spec_step(p)
        elif unified_chunks:
            self._launch_unified(p)
        elif self._fused_steps > 1:
            self._launch_fused(p)
        else:
            self._launch_per_step(p)

    @torch.no_grad()
    def collect(self, p: _PendingTick) -> List[StreamEvent]:
        """The tick's device-to-host half: ONE sync on the launched result,
        then delivery, retirement, metrics and the tick record."""
        events = p.events
        if p.kind == "fused":
            events.extend(self._collect_fused(p))
        elif p.kind == "unified":
            events.extend(self._collect_unified(p))
        elif p.kind == "spec_fused":
            events.extend(self._collect_spec_fused(p))
        elif p.kind == "spec":
            events.extend(self._collect_spec_step(p))
        elif p.kind == "step":
            events.extend(self._collect_per_step(p))
        decoded = p.kind != "idle"
        if self._prefix is not None:
            entry_bytes = None
            if self._radix is not None:
                entry_bytes = self._radix.device_bytes
            elif self._paged:
                entry_bytes = self.pool.bytes_per_block * sum(
                    len(blocks) for blocks, _ in self._prefix.values())
            self.metrics.sync_prefix_cache(self._prefix, entry_bytes=entry_bytes)
            if self._radix is not None:
                self.metrics.sync_host_tier(self._radix)
                if self._radix.disk is not None:
                    self.metrics.sync_disk_tier(self._radix)
        if self._paged:
            self.metrics.sync_block_pool(self.pool, active_tokens=p.active_tokens)
        if p.admitted or p.chunks_advanced:
            stall = STALL_PREFILL
        elif decoded and self._spec_width > 0:
            stall = STALL_SPEC_VERIFY  # the decode slot went to verifying drafts
        elif not decoded:
            stall = STALL_QUEUE_EMPTY
        else:
            stall = STALL_NONE
        end = self.clock()
        self.metrics.record_tick(
            now=end,
            queue_depth=self.scheduler.depth,
            occupancy=self.pool.occupancy,
            new_tokens=sum(1 for ev in events if ev.token >= 0),
            prefills=len(p.admitted),
            decoded=decoded,
            stall=stall,
            host_ms=(end - p.start) * 1000.0,
        )
        if p.overlapped:
            self.metrics.record_overlap()
        if p.tick_span is not None:
            p.tick_span.finish(stall=stall, queue_depth=self.scheduler.depth,
                               admitted=len(p.admitted), decoded=decoded)
        return events

    def has_work(self) -> bool:
        return self.scheduler.depth > 0 or bool(self._active.any()) or bool(self._chunking)

    def _can_launch_ahead(self) -> bool:
        """True when the next tick may launch before the pending one
        collects: a pure-decode fused tick that reads no host-side state
        (device state current, queue empty, no chunk work)."""
        return (
            self._fused_steps > 1
            and not self._state_dirty
            and not self._chunking
            and self.scheduler.depth == 0
            and bool(self._active.any())
        )

    def run(self, max_ticks: Optional[int] = None, overlap: bool = False) -> List[StreamEvent]:
        """Tick until idle (or ``max_ticks``); returns all events.

        ``overlap=True`` runs a one-tick-deep pipeline: on pure-decode
        stretches tick N+1 launches before tick N's results are collected,
        so tick N's sync and delivery overlap tick N+1's device work.  The
        output is bitwise equal to the sequential loop: a slot finishing in
        tick N is already dead in the device live mask tick N+1 carries."""
        events: List[StreamEvent] = []
        ticks = 0
        if not overlap:
            while self.has_work() and (max_ticks is None or ticks < max_ticks):
                events.extend(self.step())
                ticks += 1
            return events
        pending: Optional[_PendingTick] = None
        while True:
            if pending is not None:
                if self._can_launch_ahead() and (max_ticks is None or ticks < max_ticks):
                    nxt = self.launch(ahead=True)
                    ticks += 1
                    events.extend(self.collect(pending))
                    pending = nxt
                else:
                    events.extend(self.collect(pending))
                    pending = None
                continue
            if not self.has_work() or (max_ticks is not None and ticks >= max_ticks):
                break
            pending = self.launch()
            ticks += 1
        return events

    def reset_metrics(self, metrics: Optional[ServingMetrics] = None) -> ServingMetrics:
        """Swap in a fresh metrics record (new registry unless ``metrics``
        brings one) and rewire the scheduler to it; returns it."""
        if metrics is None:
            metrics = ServingMetrics(logger=self.metrics.logger, log_every=self.metrics.log_every)
        self.metrics = metrics
        self.registry = self.metrics.registry
        self.scheduler.registry = self.registry
        if self._paged:
            # the pool's COW/share tallies are cumulative: watermark them so
            # the fresh record's counters start at zero
            self.metrics.seed_block_pool(self.pool)
        return self.metrics

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """The weights this engine serves, as the model's own state dict:
        the tensors ALIAS the model's (``rebind_params`` writes into them),
        so a caller that keeps them across a rebind copies them."""
        return self.model.state_dict()

    @torch.no_grad()
    def rebind_params(self, state_dict, version: Optional[str] = None) -> None:
        """Swap the served weights IN PLACE: ``copy_`` each tensor of
        ``state_dict`` into the model's parameter of the same name, so every
        address (and a captured CUDA graph) stays valid, and drop every
        cached prefix.  Names, shapes and dtypes must match the model's
        exactly (:func:`validate_same_shapes`, the one check ``begin_swap``
        also runs; ``ValueError`` names the first mismatch); work in flight
        raises ``RuntimeError``."""
        if self.has_work():
            raise RuntimeError(
                f"rebind_params with work in flight ({self.in_flight} slots, "
                f"{self.scheduler.depth} queued) — drain or relocate before swapping weights"
            )
        current = self.params
        try:
            validate_same_shapes(current, state_dict)
        except ValueError as exc:
            raise ValueError(
                f"rebind_params: {exc} — same-shape swaps only (a reshape needs a new engine)"
            ) from None
        for name, old in current.items():
            old.copy_(state_dict[name])
        # cached K/V is a function of the weights: a prefix the old weights
        # wrote must never be hit again (the JAX engine keeps its caches
        # across a rebind and serves such hits)
        if self._radix is not None:
            self._radix.clear()
        elif self._prefix is not None:
            while self._prefix.pop_lru():
                pass
        if version is not None:
            self.weights_version = version
            if self._radix is not None:
                # future disk spills stamp the new version; chains persisted
                # under the old weights refuse typed at hydrate
                self._radix.weights_version = version

    # -- KV block export / import (cross-replica migration) ----------------

    def export_prefix(self, request_id: str) -> Optional[KVPrefixExport]:
        """Export a live request's written KV prefix as host bytes: the
        source half of migration.  Covers the FULL blocks of the columns
        written so far (a decoding slot has written ``prompt +
        delivered[:-1]``, a mid-chunked-prefill slot its chunk offset), so
        the import is always a usable lookup key for the forced-prefix
        replay.  None when nothing is exportable (fixed-slot engine,
        unknown request, less than one full block written)."""
        if not self._paged:
            return None
        slot = next((i for i, out in enumerate(self._slot_out)
                     if out is not None and out.request.request_id == request_id), None)
        if slot is None:
            return None
        out = self._slot_out[slot]
        if slot in self._chunking:
            written = self._chunking[slot].offset
            ctx = tuple(int(t) for t in out.request.prompt)
        elif self._active[slot]:
            written = int(self._pos[slot])
            ctx = tuple(int(t) for t in out.request.prompt) + tuple(int(t) for t in out.tokens)
        else:
            return None
        bt = self.pool.block_tokens
        n = min(written, len(ctx)) // bt
        if n <= 0:
            return None
        blocks = [int(self.pool.block_table[slot, j]) for j in range(n)]
        if any(b < 0 for b in blocks):
            return None  # belt and braces: written columns are mapped
        return self._export(ctx[:n * bt], blocks)

    def _export(self, tokens, blocks) -> KVPrefixExport:
        leaves = tuple(self.pool.export_blocks(list(blocks)))
        return KVPrefixExport(
            tokens=tuple(tokens), length=len(tokens), block_tokens=self.pool.block_tokens,
            weights_version=self.weights_version, meta=self.pool.export_meta, leaves=leaves,
            checksums=block_checksums(list(leaves), len(blocks)),
        )

    def export_hot_prefixes(self, max_blocks: int = 16) -> List[KVPrefixExport]:
        """Export the radix tree's hottest resident chains (up to
        ``max_blocks`` distinct blocks): the donor half of a scale-up warm
        start.  Empty without a radix cache."""
        if self._radix is None:
            return []
        return [self._export(tokens, blocks)
                for tokens, blocks in self._radix.hottest_chains(max_blocks)]

    def import_prefix(self, export: KVPrefixExport) -> str:
        """Land an exported KV prefix (from either package) in THIS
        engine's prefix cache, so the next admission of a matching prompt
        HITS instead of re-prefilling.  Returns a typed verdict
        (``kv_hierarchy.MIGRATION_STATUSES``): everything except
        ``imported`` / ``already_cached`` is a counted fallback and the
        caller recomputes.  Refuses typed on a block-size or shape
        mismatch and on a ``weights_version`` mismatch (cached K/V is a
        function of the weights)."""
        if not self._paged:
            return MIGRATE_NOT_PAGED
        if self._prefix is None:
            return MIGRATE_NO_PREFIX_CACHE
        if export.weights_version != self.weights_version:
            return MIGRATE_WEIGHTS_VERSION
        if export.block_tokens != self.pool.block_tokens or export.meta != self.pool.export_meta:
            return MIGRATE_INCOMPATIBLE
        tokens = tuple(int(t) for t in export.tokens)
        if self._radix is not None:
            if self._radix.covers(tokens, export.length):
                return MIGRATE_ALREADY_CACHED
            try:
                blocks = self.pool.import_stored(list(export.leaves), export.n_blocks,
                                                 checksums=export.checksums or None)
            except KVIntegrityError:
                # bytes rotted in transit or at rest: the replay recomputes
                return MIGRATE_INTEGRITY
            if blocks is None:
                return MIGRATE_NO_BLOCKS
            dupes = self._radix.insert(tokens, blocks)
            if dupes:
                self.pool.free_stored(dupes)
            return MIGRATE_IMPORTED
        # aligned-LRU target: store under the largest bucket key the export
        # covers (lookups probe bucket-aligned keys only)
        width = max((b for b in self._buckets or () if b <= export.length), default=0)
        if width <= 0:
            return MIGRATE_NO_KEY
        key = tokens[:width]
        if key in self._prefix:
            return MIGRATE_ALREADY_CACHED
        need = self.pool.blocks_needed(width)
        try:
            blocks = self.pool.import_stored(
                [leaf[:need] for leaf in export.leaves], need,
                checksums=export.checksums[:need] if export.checksums else None)
        except KVIntegrityError:
            return MIGRATE_INTEGRITY
        if blocks is None:
            return MIGRATE_NO_BLOCKS
        if not self._prefix.store_one(key, width, blocks):
            self.pool.free_stored(blocks)  # lost the store race
            return MIGRATE_ALREADY_CACHED
        return MIGRATE_IMPORTED

    @property
    def decode_steps_per_tick(self) -> int:
        """Decode steps (spec: draft-verify blocks) per fused tick (1 = the
        per-step engine)."""
        return self._fused_steps

    @property
    def unified_tick(self) -> bool:
        """True when chunked-prefill and decode slots advance in ONE tick
        body ("auto" = on whenever the fused tick is)."""
        return self._unified and self._fused_steps > 1

    @property
    def prefill_buckets(self) -> Optional[Tuple[int, ...]]:
        return self._buckets

    @property
    def prefill_compiles(self) -> int:
        """Distinct prefill/extend call shapes this engine has issued (the
        JAX engine's compile count; shapes matter here for kernel choice)."""
        return len(self._prefill_shapes)

    # -- admission ---------------------------------------------------------

    def _bucket_for(self, length: int) -> int:
        for b in self._buckets:
            if b >= length:
                return b
        raise AssertionError(f"no bucket >= {length} (buckets {self._buckets})")

    def _device_table(self) -> torch.Tensor:
        """The device copy of the pool's host-authoritative block table, at
        a fixed address (the captured graphs read it), rewritten in place
        only when the allocator moved a mapping (``table_version``).  The
        upload is stream-ordered after any tick still running."""
        if self._table_version != self.pool.table_version:
            self._dev_table.copy_(self._staged(self.pool.block_table.astype(np.int64)),
                                  non_blocking=True)
            self._table_version = self.pool.table_version
        return self._dev_table

    def _staged(self, array) -> torch.Tensor:
        """A host copy of ``array`` an asynchronous host-to-device copy may
        read (pinned on a CUDA device: the caching host allocator keeps it
        alive until the copy has run)."""
        host = torch.from_numpy(np.array(array))
        return host.pin_memory() if self.device.type == "cuda" else host

    def _block_gate(self) -> Callable[[RequestOutput], bool]:
        """Admission gate for ONE scheduling pass: a candidate must fit its
        WORST-CASE block footprint (``ceil((prompt + max_new_tokens) /
        block_tokens)`` plus the copy-on-write reserve) inside the free
        blocks not already owed to in-flight slots; the closure keeps its
        own running reservation so one tick's admissions cannot jointly
        overcommit.  A refused candidate first evicts least-recently-used
        prefix entries (they hold refcounted blocks indefinitely); only
        then does it wait (head-of-line) for running requests to retire."""
        pool = self.pool
        reserved = 0

        def gate(out: RequestOutput) -> bool:
            nonlocal reserved
            need = (pool.blocks_needed(len(out.request.prompt) + out.request.max_new_tokens)
                    + self._cow_reserve)
            avail = pool.blocks_available() - reserved
            while need > avail and self._prefix is not None and self._prefix.pop_lru():
                # an evicted entry frees its blocks only if no live slot
                # still maps them: recompute rather than assume
                avail = pool.blocks_available() - reserved
            if need > avail:
                return False
            reserved += need
            return True

        return gate

    def _release_prefix_entry(self, entry) -> None:
        """Prefix-cache eviction hook (paged): hand the evicted entry's
        block references back to the allocator."""
        blocks, _length = entry
        self.pool.free_stored(blocks)

    def _admission_key(self, out: RequestOutput):
        """Scheduler grouping key: same-bucket requests batch into one
        prefill; a chunked prompt gets a key of its own (it admits alone),
        except under the unified tick, where every chunk start shares one
        key and rides the same fixed-shape chunk phase."""
        length = len(out.request.prompt)
        if self._chunk_tokens is not None and length > self._chunk_tokens:
            if self.unified_tick:
                return ("chunk",)
            return ("chunk", id(out))
        if self._buckets is None:
            return ("exact",)
        return ("bucket", self._bucket_for(length))

    def _admit_batch(self, admitted: List[RequestOutput]) -> List[StreamEvent]:
        """Route one tick's admissions: chunked prompts start their slot,
        prefix hits run as batched remainder extends (grouped by prefix
        length and remainder bucket), the rest as one padded batched
        prefill (or batch-1 exact calls without buckets)."""
        events: List[StreamEvent] = []
        batch: List[RequestOutput] = []
        hit_groups: Dict[Tuple[int, int], list] = {}
        if self.tracer.enabled:
            for out in admitted:
                span = self._queue_spans.pop(out.request.request_id, None)
                if span is not None:
                    span.finish()
        if self._paged:
            return self._admit_batch_paged(admitted)
        for out in admitted:
            length = len(out.request.prompt)
            if self._chunk_tokens is not None and length > self._chunk_tokens:
                events.extend(self._start_chunked(out))
                continue
            if self._prefix is not None:
                hit = self._prefix.lookup(out.request.prompt, self._buckets)
                if hit is not None:
                    row, plen = hit
                    key = (plen, self._bucket_for(length - plen))
                    hit_groups.setdefault(key, []).append((out, row))
                    continue
            batch.append(out)
        for (plen, width), group in hit_groups.items():
            events.extend(self._admit_prefix_batch(group, plen, width))
        if not batch:
            return events
        if self._buckets is None:
            for out in batch:
                events.append(self._admit_exact(out))
            return events
        events.extend(self._admit_bucketed(batch))
        return events

    def _as_device(self, array, dtype=torch.long) -> torch.Tensor:
        return torch.as_tensor(np.asarray(array), dtype=dtype).to(self.device)

    def _admit_exact(self, out: RequestOutput) -> StreamEvent:
        req = out.request
        slot = self.pool.acquire()
        assert slot is not None, "scheduler admitted beyond free slots"
        t0 = self.tracer.now()
        length = len(req.prompt)
        prompt = self._as_device([list(req.prompt)])
        positions = torch.arange(length, device=self.device).expand(1, length)
        logits, fresh = _prefill_core(self.model, prompt, positions,
                                      self._as_device([length - 1]))
        self._prefill_shapes.add(("prefill", 1, length))
        self.metrics.record_prefill_call()
        self.pool.insert(fresh, slot)
        tok0 = self._sample_first(logits, [out])[0]
        if self.tracer.enabled:
            self.tracer.record("prefill", f"slot {slot}", t0, self.tracer.now(),
                               request_id=req.request_id, slot=slot, bucket=length,
                               cache_hit=False)
        return self._activate(slot, out, tok0, length)

    def _admit_bucketed(self, outs: List[RequestOutput]) -> List[StreamEvent]:
        """ONE padded batched prefill for a same-bucket admission group: rows
        pad right to the bucket width, the batch pads to ``prefill_batch``
        dummy rows (dropped at the scatter), and the real rows land in their
        slots in one in-place scatter."""
        t0 = self.tracer.now()
        width = self._bucket_for(max(len(o.request.prompt) for o in outs))
        nb = max(self._prefill_batch, len(outs))
        tokens = np.zeros((nb, width), np.int64)
        lengths = np.ones(nb, np.int64)  # dummy rows: 1 real token
        slots = np.full(nb, self.pool.n_slots, np.int64)  # dummies drop
        for i, out in enumerate(outs):
            prompt = out.request.prompt
            tokens[i, : len(prompt)] = prompt
            lengths[i] = len(prompt)
            slot = self.pool.acquire()
            assert slot is not None, "scheduler admitted beyond free slots"
            slots[i] = slot
        positions, last_idx = padded_prefill_inputs(lengths, width, device=self.device)
        logits, fresh = _prefill_core(self.model, self._as_device(tokens), positions, last_idx)
        self._prefill_shapes.add(("prefill", nb, width))
        self.metrics.record_prefill_call()
        self.pool.scatter(fresh, slots)
        firsts = self._sample_first(logits, outs)
        if self.tracer.enabled:
            t1 = self.tracer.now()
            self.tracer.record("prefill_batch", "scheduler", t0, t1, bucket=width, rows=nb,
                               requests=len(outs))
            for i, out in enumerate(outs):
                self.tracer.record("prefill", f"slot {int(slots[i])}", t0, t1,
                                   request_id=out.request.request_id, slot=int(slots[i]),
                                   bucket=width, cache_hit=False)
        events = []
        for i, out in enumerate(outs):
            self._maybe_store_prefix(out, int(slots[i]))
            events.append(self._activate(int(slots[i]), out, firsts[i], int(lengths[i])))
        return events

    def _admit_prefix_batch(self, group: List[tuple], prefix_len: int,
                            width: int) -> List[StreamEvent]:
        """Prefix-cache hits sharing (prefix length, remainder bucket): stack
        the stored rows into one batch-N cache trimmed to the prefix, run
        every remainder as one padded extend, scatter the rows into their
        slots."""
        t0 = self.tracer.now()
        nb = max(self._prefill_batch, len(group))
        rows = [row for (_, row) in group]
        rows += [rows[0]] * (nb - len(rows))  # dummy rows: dropped slots
        stacked = self.pool.stack_prefix(rows, prefix_len)
        tokens = np.zeros((nb, width), np.int64)
        rems = np.ones(nb, np.int64)
        slots = np.full(nb, self.pool.n_slots, np.int64)
        for i, (out, _) in enumerate(group):
            rem = out.request.prompt[prefix_len:]
            tokens[i, : len(rem)] = rem
            rems[i] = len(rem)
            slot = self.pool.acquire()
            assert slot is not None, "scheduler admitted beyond free slots"
            slots[i] = slot
        base, last_idx = padded_prefill_inputs(rems, width, device=self.device)
        positions = torch.where(base >= 0, base + prefix_len, torch.full_like(base, -1))
        logits, ext = _extend_core(
            self.model, self._as_device(tokens), positions, last_idx,
            torch.full((nb,), prefix_len, dtype=torch.long, device=self.device), stacked,
        )
        self._prefill_shapes.add(("extend", nb, width))
        self.metrics.record_prefill_call()
        self.pool.scatter(ext, slots)
        outs = [out for (out, _) in group]
        firsts = self._sample_first(logits, outs)
        if self.tracer.enabled:
            t1 = self.tracer.now()
            self.tracer.record("prefill_batch", "scheduler", t0, t1, bucket=width, rows=nb,
                               requests=len(outs), prefix_len=prefix_len)
            for i, out in enumerate(outs):
                self.tracer.record("prefill", f"slot {int(slots[i])}", t0, t1,
                                   request_id=out.request.request_id, slot=int(slots[i]),
                                   bucket=width, cache_hit=True, prefix_len=prefix_len)
        events = []
        for i, out in enumerate(outs):
            # a hit on a SHORT prefix may re-seed a longer evicted one
            self._maybe_store_prefix(out, int(slots[i]))
            events.append(self._activate(int(slots[i]), out, firsts[i],
                                         len(out.request.prompt)))
        return events

    def _admit_batch_paged(self, admitted: List[RequestOutput]) -> List[StreamEvent]:
        """Paged admission routing: there is no whole-row prefill.  Every
        prompt (cold or prefix hit) lands DIRECTLY in the block pool
        through one batched extend per (prefix length, remainder width)
        group; a prefix hit costs a table write plus a refcount bump per
        shared block, and no K/V copy."""
        events: List[StreamEvent] = []
        groups: Dict[Tuple[int, int], list] = {}
        # free blocks this tick's admissions are owed (worst case plus the
        # copy-on-write reserve, what the block gate reserved): a radix
        # lookup restoring warm host blocks must leave this much headroom.
        # It shrinks as requests are seated (begin_slot moves their need
        # into the pool's own entitlements, which blocks_available()
        # already subtracts)
        def need(o):
            return (self.pool.blocks_needed(len(o.request.prompt) + o.request.max_new_tokens)
                    + self._cow_reserve)

        reserve = sum(need(o) for o in admitted)
        for out in admitted:
            length = len(out.request.prompt)
            if self._chunk_tokens is not None and length > self._chunk_tokens:
                events.extend(self._start_chunked(out, reserve=reserve))
                reserve -= need(out)  # seated inside _start_chunked
                continue
            plen, blocks = 0, None
            if self._prefix is not None:
                hit = self._lookup_prefix(out.request.prompt, reserve=reserve)
                if hit is not None:
                    blocks, plen = hit
                    # pin: an earlier group's prefix store can LRU-evict
                    # this entry before OUR group maps it; the pin drops
                    # right after map_prefix
                    self.pool.pin_blocks(blocks)
            width = (self._bucket_for(length - plen) if self._buckets is not None
                     else length - plen)
            groups.setdefault((plen, width), []).append((out, blocks))
        for (plen, width), group in groups.items():
            events.extend(self._admit_extend_paged(group, plen, width))
        return events

    def _admit_extend_paged(self, group: List[tuple], plen: int,
                            width: int) -> List[StreamEvent]:
        """ONE batched extend for a same-(prefix, width) paged admission
        group: each row maps its shared prefix blocks (refcount bumps),
        allocates writable blocks for its remainder and writes its K/V
        straight into the pool through its table row.  Dummy batch rows
        pass an all -1 table, so every write of theirs is dropped."""
        t0 = self.tracer.now()
        nb = max(self._prefill_batch, len(group))
        tokens = np.zeros((nb, width), np.int64)
        rems = np.ones(nb, np.int64)
        table = np.full((nb, self.pool.max_blocks), -1, np.int64)
        slots: List[int] = []
        for i, (out, blocks) in enumerate(group):
            req = out.request
            rem = req.prompt[plen:]
            tokens[i, : len(rem)] = rem
            rems[i] = len(rem)
            slot = self.pool.acquire()
            assert slot is not None, "scheduler admitted beyond free slots"
            slots.append(slot)
            self.pool.begin_slot(slot, len(req.prompt) + req.max_new_tokens,
                                 cow_reserve=self._cow_reserve)
            if blocks is not None:
                self.pool.map_prefix(slot, blocks, plen)
                self.pool.free_stored(blocks)  # drop the admission pin
            self.pool.ensure_writable(slot, plen, len(req.prompt))
            table[i] = self.pool.block_table[slot]
        base, last_idx = padded_prefill_inputs(rems, width, device=self.device)
        positions = torch.where(base >= 0, base + plen, torch.full_like(base, -1))
        logits, _ = _extend_core(
            self.model, self._as_device(tokens), positions, last_idx,
            torch.full((nb,), plen, dtype=torch.long, device=self.device), self.pool.cache,
            self._as_device(table),
        )
        self._prefill_shapes.add(("extend", nb, width))
        self.metrics.record_prefill_call()
        outs = [out for (out, _) in group]
        firsts = self._sample_first(logits, outs)
        if self.tracer.enabled:
            t1 = self.tracer.now()
            self.tracer.record("prefill_batch", "scheduler", t0, t1, bucket=width, rows=nb,
                               requests=len(outs), prefix_len=plen)
            for i, out in enumerate(outs):
                self.tracer.record("prefill", f"slot {slots[i]}", t0, t1,
                                   request_id=out.request.request_id, slot=slots[i],
                                   bucket=width, cache_hit=plen > 0, prefix_len=plen)
        events = []
        for i, out in enumerate(outs):
            # store BEFORE activating: a request finishing on its first
            # token releases its slot inside _activate, wiping the table
            # the snapshot needs
            self._maybe_store_prefix(out, slots[i])
            events.append(self._activate(slots[i], out, firsts[i], len(out.request.prompt)))
        return events

    def _extend_slot(self, slot: int, tokens_seq, offset: int, width: int) -> torch.Tensor:
        """Extract the slot's row, extend it with ``tokens_seq`` (padded right
        to ``width``) at columns ``offset + [0..)``, write it back; returns
        the extension's last real logits."""
        take = len(tokens_seq)
        tokens = np.zeros((1, width), np.int64)
        tokens[0, :take] = tokens_seq
        base, last_idx = padded_prefill_inputs([take], width, device=self.device)
        positions = torch.where(base >= 0, base + offset, torch.full_like(base, -1))
        if self._paged:
            # the chunk writes straight into the pool through the slot's
            # table row: no extract/insert round trip exists
            self.pool.ensure_writable(slot, offset, offset + take)
            logits, _ = _extend_core(self.model, self._as_device(tokens), positions, last_idx,
                                     self._as_device([offset]), self.pool.cache,
                                     self._as_device(self.pool.block_table[slot:slot + 1]))
            self._prefill_shapes.add(("extend", 1, width))
            return logits
        row = self.pool.extract(slot)
        logits, row = _extend_core(self.model, self._as_device(tokens), positions, last_idx,
                                   self._as_device([offset]), row)
        self._prefill_shapes.add(("extend", 1, width))
        self.pool.insert(row, slot)
        return logits

    def _lookup_prefix(self, prompt, reserve: int = 0):
        """Hierarchy-aware prefix probe: the radix tree matches at block
        granularity (restoring warm host- or disk-tier blocks only within
        the ``reserve`` headroom the admission gate has not promised away);
        the aligned-LRU cache probes its bucket keys.  One counted hit or
        miss either way."""
        if self._radix is not None:
            return self._radix.lookup(prompt, reserve=reserve)
        return self._prefix.lookup(prompt, self._buckets)

    def _start_chunked(self, out: RequestOutput, reserve: int = 0) -> List[StreamEvent]:
        """Claim a slot for a long prompt and run its first chunk (the rest
        advance one per tick; under the unified tick the first one too,
        inside this tick's body).  A prefix hit seeds the slot and chunking
        starts at the prefix boundary.  ``reserve``: see
        :meth:`_lookup_prefix`."""
        req = out.request
        slot = self.pool.acquire()
        assert slot is not None, "scheduler admitted beyond free slots"
        offset = 0
        if self._paged:
            self.pool.begin_slot(slot, len(req.prompt) + req.max_new_tokens,
                                 cow_reserve=self._cow_reserve)
            # begin_slot just moved this request's need into the pool's
            # entitlements: drop it from the restore headroom
            reserve = max(0, reserve - self.pool.blocks_needed(len(req.prompt)
                                                               + req.max_new_tokens)
                          - self._cow_reserve)
        if self._prefix is not None:
            hit = self._lookup_prefix(req.prompt, reserve=reserve)
            if hit is not None:
                row, offset = hit
                if self._paged:
                    # table writes; the first chunk's writes into a shared
                    # tail block copy-on-write through ensure_writable
                    self.pool.map_prefix(slot, row, offset)
                else:
                    self.pool.copy_prefix(row, slot, offset)
        if offset == 0 and not self._paged:
            # incremental writes from here on: invalidate the previous
            # occupant now (a whole-row insert never happens; a paged slot
            # needs none, release() invalidated its freed blocks)
            self.pool.clear(slot)
        out.status = RUNNING
        self._slot_out[slot] = out
        self._chunking[slot] = _ChunkState(out, offset)
        if self.unified_tick:
            # activation may happen inside the body: the slot's knobs must
            # reach the device state before then
            sp = req.sampling
            self._temp[slot], self._topk[slot], self._topp[slot] = (
                sp.temperature, sp.top_k, sp.top_p)
            self._set_spec_cap(slot, req)
            self._state_dirty = True
            return []
        return self._advance_chunk(slot)

    def _advance_chunk(self, slot: int) -> List[StreamEvent]:
        """Run ONE chunk of the slot's prefill; on the final chunk sample the
        first token and activate the slot for decode."""
        st = self._chunking[slot]
        prompt = st.out.request.prompt
        take = min(self._chunk_tokens, len(prompt) - st.offset)
        t0 = self.tracer.now()
        chunk_index = st.offset // self._chunk_tokens
        logits = self._extend_slot(slot, prompt[st.offset: st.offset + take],
                                   offset=st.offset, width=self._chunk_tokens)
        st.offset += take
        self.metrics.record_prefill_call(chunks=1)
        if self.tracer.enabled:
            self.tracer.record("prefill_chunk", f"slot {slot}", t0, self.tracer.now(),
                               request_id=st.out.request.request_id, slot=slot,
                               chunk=chunk_index, offset=st.offset,
                               final=st.offset >= len(prompt))
        if st.offset < len(prompt):
            return []
        del self._chunking[slot]
        tok0 = self._sample_first(logits, [st.out])[0]
        self._maybe_store_prefix(st.out, slot)
        return [self._activate(slot, st.out, tok0, len(prompt))]

    def _maybe_store_prefix(self, out: RequestOutput, slot: int) -> None:
        """Seed the prefix cache from a freshly prefilled slot row (every
        bucket-aligned proper prefix of the prompt, first writer wins); the
        row is copied (paged: its blocks shared) only when some key would
        be new."""
        if self._prefix is None:
            return
        prompt = tuple(int(t) for t in out.request.prompt)
        if self._radix is not None:
            # radix store: index the prompt's FULL blocks, so every block
            # boundary is a match point and sharers never write into a
            # shared block.  snapshot_blocks hands one reference per block;
            # the tree keeps those of new nodes and returns the duplicates
            bt = self.pool.block_tokens
            full = (len(prompt) // bt) * bt
            if full <= 0 or self._radix.covers(prompt, full):
                return
            dupes = self._radix.insert(prompt[:full], self.pool.snapshot_blocks(slot, full))
            if dupes:
                self.pool.free_stored(dupes)
            return
        if all(b >= len(prompt) or prompt[:b] in self._prefix for b in self._buckets):
            return
        if self._paged:
            # per-key refcounted block snapshots, NO K/V copies: the
            # owner's next write into a snapshotted block copy-on-writes
            # away, so a stored prefix is immutable from this moment
            for b in self._buckets:
                if b >= len(prompt) or prompt[:b] in self._prefix:
                    continue
                blocks = self.pool.snapshot_blocks(slot, b)
                if not self._prefix.store_one(prompt[:b], b, blocks):
                    self.pool.free_stored(blocks)  # lost the store race
            return
        self._prefix.store(prompt, self._buckets, self.pool.extract(slot))

    def _sample_first(self, logits, outs: List[RequestOutput]) -> List[int]:
        """Sample each admitted request's first token from its prefill
        logits (rows beyond ``outs`` are a padded batch's dummies, sampled
        greedily and discarded)."""
        nb = logits.shape[0]
        temp = np.zeros(nb, np.float32)
        topk = np.zeros(nb, np.int64)
        topp = np.zeros(nb, np.float32)
        for i, out in enumerate(outs):
            sp = out.request.sampling
            temp[i], topk[i], topp[i] = sp.temperature, sp.top_k, sp.top_p
        first = sample_tokens(logits, self._gen, self._as_device(temp, torch.float32),
                              self._as_device(topk), self._as_device(topp, torch.float32))
        first = first.cpu().numpy()
        return [int(first[i]) for i in range(len(outs))]

    def _activate(self, slot: int, out: RequestOutput, tok0: int, prompt_len: int) -> StreamEvent:
        """Commit an admitted request to its slot: decode state, knobs,
        first-token delivery."""
        sp = out.request.sampling
        self._tok[slot] = tok0
        self._pos[slot] = prompt_len
        self._widx[slot] = prompt_len
        self._temp[slot] = sp.temperature
        self._topk[slot] = sp.top_k
        self._topp[slot] = sp.top_p
        self._set_spec_cap(slot, out.request)
        self._active[slot] = True
        self._slot_out[slot] = out
        self._state_dirty = True
        out.status = RUNNING
        out.first_token_time = self.clock()
        return self._deliver(slot, tok0)

    def _set_spec_cap(self, slot: int, request: Request) -> None:
        """The slot's speculative draft cap: the request's ``draft_tokens``
        (None inherits the engine's; a larger ask clamps to the engine's
        verify width), which the adaptive length starts at."""
        req_k = request.draft_tokens
        cap = self._spec_width if req_k is None else min(req_k, self._spec_width)
        self._spec_max[slot] = cap
        self._spec_k[slot] = cap

    # -- per-step tick -----------------------------------------------------

    def _launch_per_step(self, p: _PendingTick) -> None:
        table = None
        if self._paged:
            seq_len = self.model.config.seq_len
            for slot in p.entering:
                w = int(self._widx[slot])
                if w < seq_len:
                    self.pool.ensure_writable(slot, w, w + 1)
            table = self._device_table()
        nxt = _decode_core(
            self.model, self._as_device(self._tok), self._as_device(self._pos),
            self._as_device(self._widx), self._as_device(self._temp, torch.float32),
            self._as_device(self._topk), self._as_device(self._topp, torch.float32),
            self.pool.cache, self._gen, table,
        )
        p.kind = "step"
        p.payload = nxt

    def _collect_per_step(self, p: _PendingTick) -> List[StreamEvent]:
        nxt = p.payload.cpu().numpy()  # ONE sync
        events = []
        trace = self.tracer.enabled
        t1 = self.tracer.now()
        if trace:
            self.tracer.record("decode_tick", "scheduler", p.t0, t1)
        # every entering slot's current token was just written; advance
        # even the slots that retire on this token's delivery
        for slot in p.entering:
            if not self._active[slot]:
                continue  # an earlier slot's on_token callback cancelled it
            if trace:
                out = self._slot_out[slot]
                self.tracer.record("decode", f"slot {slot}", p.t0, t1,
                                   request_id=out.request.request_id, slot=slot,
                                   token_index=len(out.tokens))
            self._pos[slot] += 1
            self._widx[slot] += 1
            self._tok[slot] = int(nxt[slot])
            events.append(self._deliver(slot, int(nxt[slot])))
        self.metrics.record_dispatch(tokens=len(events))
        return events

    # -- fused tick --------------------------------------------------------

    def _upload_slot_state(self) -> None:
        """Rewrite the device slot state and knobs in place from the host
        mirrors; runs only after a host-side change (admission, release,
        cancel).  Budget is each live request's remaining new tokens; EOS
        is -1 for requests without one, and mid-chunked-prefill slots give
        theirs too (the unified tick's activation checks it before the
        host sees the first token)."""
        n = self.pool.n_slots
        budget = np.zeros(n, np.int64)
        eos = np.full(n, -1, np.int64)
        for slot in np.nonzero(self._active)[0]:
            out = self._slot_out[slot]
            budget[slot] = out.request.max_new_tokens - len(out.tokens)
            if out.request.eos_token_id is not None:
                eos[slot] = int(out.request.eos_token_id)
        for slot, st in self._chunking.items():
            if st.out.request.eos_token_id is not None:
                eos[slot] = int(st.out.request.eos_token_id)
        host = [self._tok, self._pos, self._widx, self._active, budget]
        knobs = [eos, self._temp, self._topk, self._topp]
        if self._spec_fused:
            # the in-body drafter's context per slot: prompt + delivered
            # tokens (a chunking slot: its prompt; the body adds its first
            # token at activation).  The fixed-address buffer is rewritten
            # here only, through a pinned copy the caching host allocator
            # keeps alive until it has run
            seq_len = self.model.config.seq_len
            hist = np.zeros((n, seq_len + 1), np.int64)
            for slot, out in enumerate(self._slot_out):
                if out is None:
                    continue
                ctx = list(out.request.prompt)
                if self._active[slot]:
                    ctx += out.tokens
                ctx = ctx[:seq_len]
                hist[slot, :len(ctx)] = ctx
            self._dev_state[-1].copy_(self._staged(hist), non_blocking=True)
            host.append(self._spec_k)
            knobs.append(self._spec_max)
        for dst, src in zip(self._dev_state[:len(host)] + self._dev_knobs, host + knobs):
            dst.copy_(torch.from_numpy(np.ascontiguousarray(src)))
        self._state_dirty = False

    def _fused_body(self) -> None:
        """One fused tick on the device tensors, in place: the T-step body,
        the new slot state written back, block and counts into the output
        buffer.  What the fused CUDA graph captures."""
        block, counts, state = _fused_decode_core(
            self.model, self._fused_steps, *self._dev_state, *self._dev_knobs,
            self.pool.cache, self._gen, self._dev_table,
        )
        for dst, src in zip(self._dev_state, state):
            dst.copy_(src)
        self._dev_out[:-2].copy_(block)
        self._dev_out[-2].copy_(counts)

    def _unified_body(self) -> None:
        """One unified ragged tick on the device tensors, in place: the
        chunk phase over ``_dev_chunk``, then the T-step body; state, block,
        counts and the activation tokens written back.  What the unified
        CUDA graph captures."""
        act_emit, block, counts, state = _unified_tick_core(
            self.model, self._fused_steps, *self._dev_state, *self._dev_knobs,
            *self._dev_chunk, self.pool.cache, self._gen, self._dev_table,
        )
        for dst, src in zip(self._dev_state, state):
            dst.copy_(src)
        self._dev_out[:-2].copy_(block)
        self._dev_out[-2].copy_(counts)
        self._dev_out[-1].copy_(act_emit)

    def _capture_graph(self, body: Callable[[], None]) -> "torch.cuda.CUDAGraph":
        """Capture ``body`` as a CUDA graph, once per tick kind per engine.

        A warm-up run on a side stream first (PyTorch's graph rules); the
        slot state and the generator are then put back as they were, so
        the warm-up changes no result.  Its cache writes land at columns
        the next replay rewrites with the same values before reading, or
        beyond every slot's frontier where the position mask hides them.
        The engine's generator is registered with the graph so each replay
        draws new noise.  Any failure raises."""
        saved = [t.clone() for t in self._dev_state]
        gen_state = self._gen.get_state()
        side = torch.cuda.Stream(device=self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            body()
        torch.cuda.current_stream(self.device).wait_stream(side)
        for dst, src in zip(self._dev_state, saved):
            dst.copy_(src)
        self._gen.set_state(gen_state)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self._gen)
        with torch.cuda.graph(graph):
            body()
        self.graph_captures += 1
        return graph

    def _run_fused_eagerly(self) -> None:
        """Run the fused and unified bodies eagerly on a CUDA device instead
        of replaying their graphs: the reference the captured ticks are
        held against (the same bodies, kernel for kernel)."""
        self._use_graphs = False

    def _replay(self, kind: str, body: Callable[[], None]) -> None:
        """Run one tick body: a replay of its graph (captured on first use)
        on a CUDA device, else eagerly."""
        if not self._use_graphs:
            body()
            return
        if kind not in self._graphs:
            self._graphs[kind] = self._capture_graph(body)
        self._graphs[kind].replay()

    def _ensure_decode_writable(self, p: _PendingTick, width: int) -> None:
        """Paged launches: make every column this tick CAN write writable up
        front (budget-clamped, so a finishing slot never draws blocks beyond
        its entitlement); the table then stays loop-invariant through the
        body.  ``width`` is the tick's per-slot column advance; a
        launch-ahead doubles it, since the host mirrors lag the in-flight
        tick by up to one width."""
        seq_len = self.model.config.seq_len
        if p.overlapped:
            width *= 2
        for slot in p.entering:
            out = self._slot_out[slot]
            if out is None:
                continue
            w = int(self._widx[slot])
            rem = out.request.max_new_tokens - len(out.tokens)
            self.pool.ensure_writable(slot, w, min(w + min(width, max(rem, 0)), seq_len))
        for slot, out, plen in p.finals:
            # a chunk completing this tick activates in the body and
            # decodes from its prompt length at once
            self.pool.ensure_writable(
                slot, plen, min(plen + min(width, out.request.max_new_tokens), seq_len))

    def _launch_fused(self, p: _PendingTick) -> None:
        """Launch one fused tick: T masked decode steps (one graph replay on
        a CUDA device), then an asynchronous copy of block and counts to a
        host buffer that :meth:`_collect_fused` syncs on."""
        if self._state_dirty:
            self._upload_slot_state()
        if self._paged:
            self._ensure_decode_writable(p, self._fused_steps)
            self._device_table()
        self._replay("fused", self._fused_body)
        p.kind = "fused"
        p.payload = self._copy_out()

    def _copy_out(self):
        """Copy the output buffer to the next host buffer, asynchronously;
        returns (host buffer, event recorded after the copy, or None)."""
        host = self._host_out[self._host_turn]
        self._host_turn ^= 1
        host.copy_(self._dev_out, non_blocking=True)
        done = None
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
        return host, done

    def _build_chunk_block(self, p: _PendingTick) -> None:
        """Fold every in-flight chunked prefill into this tick's unified
        body: fill the fixed ``[n_slots, chunk]`` right-padded chunk block
        in place, advance each slot's offset, and mark the slots whose
        chunk COMPLETES the prompt (they activate in the body; the host
        finishes their bookkeeping at collect).  Paged slots make their
        chunk's columns writable here, before the launch."""
        cfg = self.model.config
        n, width = self.pool.n_slots, self._chunk_tokens
        ctoks = np.zeros((n, width), np.int64)
        clen = np.zeros(n, np.int64)
        cstart = np.full(n, cfg.seq_len, np.int64)
        cfinal = np.zeros(n, bool)
        cbudget = np.ones(n, np.int64)
        for slot in sorted(self._chunking):
            st = self._chunking[slot]
            prompt = st.out.request.prompt
            take = min(width, len(prompt) - st.offset)
            ctoks[slot, :take] = prompt[st.offset: st.offset + take]
            clen[slot] = take
            cstart[slot] = st.offset
            if self._paged:
                self.pool.ensure_writable(slot, st.offset, st.offset + take)
            p.chunk_spans.append((slot, st.out.request.request_id, st.offset // width,
                                  st.offset + take, st.offset + take >= len(prompt)))
            st.offset += take
            p.chunk_tokens += take
            if st.offset >= len(prompt):
                cfinal[slot] = True
                cbudget[slot] = st.out.request.max_new_tokens
                p.finals.append((slot, st.out, len(prompt)))
        for slot, _, _ in p.finals:
            del self._chunking[slot]
        for dst, src in zip(self._dev_chunk, (ctoks, clen, cstart, cfinal, cbudget)):
            dst.copy_(self._staged(src), non_blocking=True)

    def _launch_unified(self, p: _PendingTick) -> None:
        """Launch one unified ragged tick: the chunk phase (every mid-prefill
        slot's next chunk, in-body final-chunk activation) plus the T
        decode steps, as one body (one graph replay on a CUDA device)."""
        if self._state_dirty:
            self._upload_slot_state()
        self._build_chunk_block(p)
        if self._paged:
            self._ensure_decode_writable(p, self._fused_steps)
            self._device_table()
        self._replay("unified", self._unified_body)
        p.kind = "unified"
        p.payload = self._copy_out()

    def _check_progress(self, p: _PendingTick, counts) -> None:
        """A slot decode-live at launch enters the tick live with budget >= 1,
        so zero progress means the device state desynced from the host
        mirrors: fail loudly instead of spinning forever."""
        stuck = [s for s in p.entering if counts[s] == 0 and self._active[s]]
        if stuck:
            raise RuntimeError(
                f"fused tick made no progress on active slots {stuck} (device "
                f"live={self._dev_state[3].cpu().tolist()}, budget="
                f"{self._dev_state[4].cpu().tolist()}) — slot state desynced from host mirrors"
            )

    def _deliver_block(self, p: _PendingTick, block, counts, t1) -> List[StreamEvent]:
        """Deliver a fused tick's [T, n_slots] token block through the
        per-token delivery path."""
        events: List[StreamEvent] = []
        trace = self.tracer.enabled
        for slot in np.nonzero(self._active)[0]:
            slot = int(slot)
            c = int(counts[slot])
            # re-check: a stream callback may have cancelled this slot
            if c == 0 or not self._active[slot]:
                continue
            if trace:
                out = self._slot_out[slot]
                self.tracer.record("decode", f"slot {slot}", p.t0, t1,
                                   request_id=out.request.request_id, slot=slot,
                                   token_index=len(out.tokens), tokens=c)
            # mirrors advance by the full progress BEFORE delivery (which may
            # release the slot and park the mirror again)
            self._pos[slot] += c
            self._widx[slot] += c
            self._tok[slot] = int(block[c - 1, slot])
            for t in range(c):
                event = self._deliver(slot, int(block[t, slot]))
                events.append(event)
                if event.finish_reason == FAIL_INTEGRITY:
                    break  # everything after non-finite logits is garbage
                if event.finished and t != c - 1:
                    raise AssertionError(
                        f"slot {slot}: host finished at token {t + 1} of a {c}-token "
                        "device block"
                    )
                if not self._active[slot]:
                    break  # finished, or cancelled by the on_token callback
        return events

    @staticmethod
    def _sync_out(p: _PendingTick):
        """ONE sync on a fused or unified tick's output copy; returns (block
        [T, n], counts [n], activation tokens [n]) as numpy."""
        host, done = p.payload
        if done is not None:
            done.synchronize()
        out = host.numpy()
        return out[:-2], out[-2], out[-1]

    def _collect_fused(self, p: _PendingTick) -> List[StreamEvent]:
        """Collect one fused tick: ONE sync per T decode steps, then the
        per-token delivery path (greedy output bitwise equal to the
        per-step tick's; streaming granularity becomes per tick)."""
        block, counts, _ = self._sync_out(p)
        self._check_progress(p, counts)
        t1 = self.tracer.now()
        if self.tracer.enabled:
            self.tracer.record("decode_tick", "scheduler", p.t0, t1, steps=self._fused_steps,
                               tokens=int(counts.sum()))
        events = self._deliver_block(p, block, counts, t1)
        self.metrics.record_dispatch(tokens=len(events))
        return events

    def _activate_from_device(self, slot: int, out: RequestOutput, tok0: int,
                              prompt_len: int) -> StreamEvent:
        """Finish an in-body activation on the host: the device already
        sampled the first token, turned the slot live and advanced its
        state; mirror that WITHOUT dirtying the upload flag (the device
        state is the fresher one), then deliver the first token."""
        self._tok[slot] = tok0
        self._pos[slot] = prompt_len
        self._widx[slot] = prompt_len
        self._active[slot] = True
        self._slot_out[slot] = out
        # the device started the slot's adaptive draft length at its cap
        self._spec_k[slot] = self._spec_max[slot]
        out.status = RUNNING
        out.first_token_time = self.clock()
        return self._deliver(slot, tok0)

    def _collect_unified(self, p: _PendingTick) -> List[StreamEvent]:
        """Collect one unified tick: ONE sync for the activation row and the
        decode block together; activations are delivered first (the
        per-phase engine's advance-then-decode order), then the block."""
        block, counts, act_emit = self._sync_out(p)
        t1 = self.tracer.now()
        self._collect_chunks(p, t1)
        events = [self._activate_from_device(slot, out, int(act_emit[slot]), plen)
                  for slot, out, plen in p.finals]
        self._check_progress(p, counts)
        if self.tracer.enabled:
            self.tracer.record("decode_tick", "scheduler", p.t0, t1, steps=self._fused_steps,
                               tokens=int(counts.sum()), chunk_tokens=p.chunk_tokens)
        events.extend(self._deliver_block(p, block, counts, t1))
        delivered = sum(1 for ev in events if ev.token >= 0)
        self.metrics.record_dispatch(tokens=delivered)
        # prompt tokens consumed + tokens this one body delivered
        self.metrics.record_unified_tick(p.chunk_tokens + delivered)
        return events

    def _collect_chunks(self, p: _PendingTick, t1: float) -> None:
        """Collect-side bookkeeping of the chunks folded into a unified
        tick (plain or spec): their spans and the chunk tally."""
        if self.tracer.enabled:
            for slot, rid, idx, offset, final in p.chunk_spans:
                self.tracer.record("prefill_chunk", f"slot {slot}", p.t0, t1, request_id=rid,
                                   slot=slot, chunk=idx, offset=offset, final=final)
        if p.chunk_spans:
            self.metrics.record_chunks(len(p.chunk_spans))

    # -- speculative ticks -------------------------------------------------

    def _any_sampled(self, slots) -> bool:
        """Whether any of ``slots`` samples: picks the verify variant (and
        its graph) that runs the rejection rule's sorts."""
        return any(self._temp[s] > 0.0 for s in slots)

    def _launch_spec_step(self, p: _PendingTick) -> None:
        """Launch one speculative verify tick: draft per active slot on the
        host (capped by the adaptive length, the slot's remaining budget and
        seq_len), then ONE multi-token verify forward over every slot.

        Short drafts pad with -1 positions; free and mid-chunked-prefill
        slots park their whole block at column seq_len.  A request whose
        budget or EOS lands mid-block stops delivery there: the surplus K/V
        beyond the finish lies in a slot that is being released."""
        cfg = self.model.config
        k, n = self._spec_width, self.pool.n_slots
        drafts = np.zeros((n, k), np.int64)
        dlen = np.zeros(n, np.int64)
        for slot in p.entering:
            out = self._slot_out[slot]
            d = draft_for_row(self._drafter, list(out.request.prompt) + out.tokens,
                              int(self._spec_k[slot]), int(self._widx[slot]), cfg.seq_len,
                              out.request.max_new_tokens - len(out.tokens))
            dlen[slot] = len(d)
            drafts[slot, :len(d)] = d
        table = None
        if self._paged:
            # the verify writes the current token + dlen draft columns,
            # inside the budget (draft_for_row's cap), so never beyond the
            # slot's block entitlement
            for slot in p.entering:
                w = int(self._widx[slot])
                self.pool.ensure_writable(slot, w, min(w + int(dlen[slot]) + 1, cfg.seq_len))
            table = self._device_table()
        block, accepted = _verify_core(
            self.model, self._as_device(self._tok), self._as_device(drafts),
            self._as_device(dlen), self._as_device(self._pos), self._as_device(self._widx),
            self._as_device(self._temp, torch.float32), self._as_device(self._topk),
            self._as_device(self._topp, torch.float32), self.pool.cache, self._gen, table,
            sampled=self._any_sampled(p.entering),
        )
        p.kind = "spec"
        p.payload = (block, accepted, dlen)

    def _collect_spec_step(self, p: _PendingTick) -> List[StreamEvent]:
        """Collect one speculative verify tick: one sync, then deliver each
        slot's accepted prefix + bonus token (cut at a mid-block EOS or
        length finish)."""
        k = self._spec_width
        block, accepted, dlen = p.payload
        block, accepted = block.cpu().numpy(), accepted.cpu().numpy()  # ONE sync
        events: List[StreamEvent] = []
        trace = self.tracer.enabled
        t1 = self.tracer.now()
        if trace:
            self.tracer.record("verify_tick", "scheduler", p.t0, t1, width=k)
        for slot in p.entering:
            if not self._active[slot]:
                continue  # an earlier slot's on_token callback cancelled it
            a, drafted = int(accepted[slot]), int(dlen[slot])
            if trace:
                out = self._slot_out[slot]
                self.tracer.record("verify", f"slot {slot}", p.t0, t1,
                                   request_id=out.request.request_id, slot=slot,
                                   draft_k=drafted, accepted=a, token_index=len(out.tokens))
            # the current token + a accepted drafts entered the cache; the
            # bonus (block[a]) is the new current token, written next tick
            self._pos[slot] += a + 1
            self._widx[slot] += a + 1
            self._tok[slot] = int(block[slot, a])
            delivered = 0
            for tok in block[slot, :a + 1]:
                event = self._deliver(slot, int(tok))
                events.append(event)
                delivered += 1
                if event.finished:
                    break  # EOS or length mid-block: drop the surplus
            self._after_spec_block(slot, drafted, a, delivered)
        self.metrics.record_dispatch(tokens=len(events))
        return events

    def _after_spec_block(self, slot: int, drafted: int, accepted: int, delivered: int) -> None:
        """One slot's share of a verify block: the spec counters, the
        adaptive draft length (the law the fused body applies, replayed on
        the host mirror) and the optional alignment check."""
        self.metrics.record_spec(drafted=drafted, accepted=accepted,
                                 wasted=(self._spec_width + 1) - delivered)
        if self._spec_adaptive and self._active[slot] and self._spec_max[slot] > 0:
            self._spec_k[slot] = adapt_draft_len(int(self._spec_k[slot]), drafted, accepted,
                                                 int(self._spec_max[slot]))
        if self._spec_check:
            self.pool.assert_slot_aligned(slot)

    def _spec_body(self, unified: bool, sampled: bool) -> None:
        """One fused (or, with ``unified``, unified) spec tick on the device
        tensors, in place: state written back, blocks, counts, drafted and
        accepted counts (and activation tokens) into the output buffer.
        What the spec CUDA graphs capture, one per (kind, ``sampled``)."""
        spec = (self.model, self._fused_steps, self._spec_width, self._drafter.max_ngram,
                self._drafter.min_ngram, self._spec_adaptive, sampled)
        if unified:
            act_emit, blocks, counts, drafted, accepted, state = _unified_spec_core(
                *spec, *self._dev_state, *self._dev_knobs, *self._dev_chunk, self.pool.cache,
                self._gen, self._dev_table)
            self._dev_out[-1, :, 0].copy_(act_emit)
        else:
            blocks, counts, drafted, accepted, state = _fused_spec_core(
                *spec, *self._dev_state, *self._dev_knobs, self.pool.cache, self._gen,
                self._dev_table)
        for dst, src in zip(self._dev_state, state):  # the history was updated in place
            dst.copy_(src)
        k1 = self._spec_width + 1
        out = self._dev_out[:-1]
        out[..., :k1].copy_(blocks)
        out[..., k1].copy_(counts)
        out[..., k1 + 1].copy_(drafted)
        out[..., k1 + 2].copy_(accepted)

    def _launch_spec_fused(self, p: _PendingTick, unified_chunks: bool) -> None:
        """Launch one FUSED speculative tick: T draft-verify-accept blocks
        drafting from the device-resident history (one graph replay on a
        CUDA device); with chunk work this tick, the unified chunk phase in
        front.  Each kind has a greedy and a sampled variant, chosen here
        from the host's per-slot temperatures."""
        if self._state_dirty:
            self._upload_slot_state()
        if unified_chunks:
            self._build_chunk_block(p)
        if self._paged:
            self._ensure_decode_writable(p, self._fused_steps * (self._spec_width + 1))
            self._device_table()
        slots = list(p.entering) + list(self._chunking) + [s for s, _, _ in p.finals]
        sampled = self._any_sampled(slots)
        kind = ("spec_unified" if unified_chunks else "spec_fused") + (
            "_sampled" if sampled else "")
        self._replay(kind, lambda: self._spec_body(unified_chunks, sampled))
        p.kind = "spec_fused"
        p.payload = (self._copy_out(), unified_chunks)

    def _collect_spec_fused(self, p: _PendingTick) -> List[StreamEvent]:
        """Collect one fused speculative tick: ONE sync per T verify blocks,
        then per-block delivery: each block's accepted prefix + bonus, cut
        at a mid-block finish, with the host replaying the adaptation law
        the body applied so the ``_spec_k`` mirror stays exact."""
        (host, done), unified = p.payload
        if done is not None:
            done.synchronize()
        buf = host.numpy()
        k1 = self._spec_width + 1
        blocks, counts = buf[:-1, :, :k1], buf[:-1, :, k1]
        drafted, accepted = buf[:-1, :, k1 + 1], buf[:-1, :, k1 + 2]
        events: List[StreamEvent] = []
        trace = self.tracer.enabled
        t1 = self.tracer.now()
        self._collect_chunks(p, t1)
        for slot, out, plen in p.finals:
            events.append(self._activate_from_device(slot, out, int(buf[-1, slot, 0]), plen))
        # the per-slot DELIVERED totals play the fused tick's counts role
        self._check_progress(p, counts.sum(axis=0))
        if trace:
            self.tracer.record("verify_tick", "scheduler", p.t0, t1, width=k1 - 1,
                               steps=self._fused_steps, tokens=int(counts.sum()),
                               chunk_tokens=p.chunk_tokens)
        for t in range(blocks.shape[0]):
            for slot in range(self.pool.n_slots):
                e = int(counts[t, slot])
                if e == 0 or not self._active[slot]:
                    continue
                a, d = int(accepted[t, slot]), int(drafted[t, slot])
                if trace:
                    out = self._slot_out[slot]
                    self.tracer.record("verify", f"slot {slot}", p.t0, t1,
                                       request_id=out.request.request_id, slot=slot,
                                       draft_k=d, accepted=a, token_index=len(out.tokens))
                self._pos[slot] += a + 1
                self._widx[slot] += a + 1
                self._tok[slot] = int(blocks[t, slot, a])
                delivered = 0
                for tok in blocks[t, slot, :e]:
                    event = self._deliver(slot, int(tok))
                    events.append(event)
                    delivered += 1
                    if event.finish_reason == FAIL_INTEGRITY:
                        break  # everything after non-finite logits is garbage
                    if event.finished:
                        if delivered != e:
                            # the body cut AT the finish: its EOS / budget law
                            # and _deliver's must agree token for token
                            raise AssertionError(
                                f"slot {slot}: host finished at token {delivered} of a "
                                f"{e}-token spec block")
                        break
                    if not self._active[slot]:
                        break  # cancelled mid-block by a stream callback
                self._after_spec_block(slot, d, a, delivered)
        delivered = sum(1 for ev in events if ev.token >= 0)
        self.metrics.record_dispatch(tokens=delivered)
        if unified:
            # a unified spec tick: prompt tokens consumed + tokens delivered
            self.metrics.record_unified_tick(p.chunk_tokens + delivered)
        return events

    # -- delivery ----------------------------------------------------------

    def _fail_integrity(self, slot: int) -> StreamEvent:
        """The device sampled the NaN/Inf sentinel for this slot: fail the
        request typed (``FAIL_INTEGRITY``) and release the slot without
        delivering a token."""
        out = self._slot_out[slot]
        req = out.request
        self.release_slot(slot)
        out.status = FAILED
        out.finish_reason = FAIL_INTEGRITY
        out.detail = "non-finite logits (NaN/Inf) at sampling — refusing to stream garbage tokens"
        out.finish_time = self.clock()
        self.integrity_trips += 1
        self.metrics.record_integrity_trip()
        if self.tracer.enabled:
            self.tracer.instant("integrity_trip", track=f"slot {slot}", request_id=req.request_id)
        event = StreamEvent(request_id=req.request_id, token=-1, index=-1, finished=True,
                            finish_reason=FAIL_INTEGRITY)
        if req.on_token is not None:
            req.on_token(event)
        return event

    def _deliver(self, slot: int, token: int) -> StreamEvent:
        """Record one generated token for the request in ``slot``; retire the
        slot when it finishes the request (EOS or length).  The sentinel
        never counts as a token: it fails the request typed."""
        if token == NON_FINITE_TOKEN:
            return self._fail_integrity(slot)
        out = self._slot_out[slot]
        req = out.request
        now = self.clock()
        out.tokens.append(token)
        out.token_times.append(now)
        finish_reason = None
        if req.eos_token_id is not None and token == req.eos_token_id:
            finish_reason = "eos"
        elif len(out.tokens) >= req.max_new_tokens:
            finish_reason = "length"
        event = StreamEvent(request_id=req.request_id, token=token, index=len(out.tokens) - 1,
                            finished=finish_reason is not None, finish_reason=finish_reason)
        if finish_reason is not None:
            if self.tracer.enabled:
                self.tracer.instant("finish", track=f"slot {slot}", request_id=req.request_id,
                                    reason=finish_reason, tokens=len(out.tokens))
            out.status = FINISHED
            out.finish_reason = finish_reason
            out.finish_time = now
            self.release_slot(slot)
            self.metrics.record_finished(out)
        if req.on_token is not None:
            req.on_token(event)
        return event
