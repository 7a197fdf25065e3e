"""Speculative decoding: draft-verify multi-token decode, exactly.  The port
of ``tpu_parallel/serving/spec_decode.py``.

A single-token decode step streams every weight of the model to produce
ONE token per row, so at serving batch sizes a step is bound by latency
and bytes, not by arithmetic.  Speculative decoding (Leviathan et al.
2023) buys that back: a cheap DRAFTER proposes K tokens per row, one
forward scores all K (+1 bonus position) through the multi-token
``write_index`` path the chunked prefill already uses
(:func:`~tpu_parallel_torch.models.generate.verify_step`), and an
acceptance rule keeps the longest exact prefix, so the output stream is
that of non-speculative decoding:

- greedy: accept drafts while they equal the verify argmax chain, then
  append the argmax at the first mismatch (the "bonus" token).  Every
  emitted token is the argmax the sequential loop would have produced
  (:func:`greedy_verify`).
- sampled: the Leviathan rejection rule (:func:`rejection_verify`).  The
  drafter is DETERMINISTIC (a point mass q), so draft ``d`` is accepted
  with probability ``p(d)`` under the filtered target distribution ``p``,
  and a rejection resamples from the residual ``p`` with ``d`` zeroed and
  renormalized: every emitted token's marginal is exactly ``p``, though
  the realized sequence differs from the non-spec engine's (the random
  draws are consumed differently).

Rejection needs NO cache rollback: rejected drafts' K/V sit at columns
beyond the accepted frontier, where the engine's aligned layout (column ==
stored position, ``CachePool.assert_slot_aligned``) keeps them masked
until the next verify overwrites them.

The drafter is pluggable (:class:`Drafter`); the default
:class:`NGramDrafter` is model-free prompt-lookup drafting (Saxena 2023):
propose the continuation of the most recent earlier occurrence of the
context's longest matching suffix n-gram.  :func:`ngram_draft_tokens` is
its fixed-shape tensor twin, token for token the same, which the fused
spec tick runs inside its CUDA graph.

Randomness comes from an explicit ``torch.Generator``: uniforms for the
acceptance test and a Gumbel-max draw for the bonus token, as
``engine.sample_tokens`` draws, with no host sync, so a CUDA graph can
capture them.  Sampled tokens are not the JAX package's (other random
bits); greedy tokens are.

:func:`generate_speculative` is the standalone batch loop (host-side
drafting around verify ticks); the engine's spec ticks (``ServingEngine``
with ``draft_tokens > 0``) share every tensor function with it.
"""

from __future__ import annotations

from typing import List, Optional, Protocol, Sequence, Tuple

import numpy as np
import torch

from tpu_parallel_torch.serving.sampling import filter_logits


class Drafter(Protocol):
    """Anything that proposes draft tokens for one request.

    ``draft(context, k)`` sees the request's full token history (prompt +
    everything generated so far, INCLUDING the current token whose K/V is
    not yet written) and returns up to ``k`` proposed continuation tokens
    (possibly none).  Host-side and per-slot; drafters may be stateful.
    A wrong draft can never corrupt output (the verify rule rejects it);
    it only wastes verify positions.
    """

    def draft(self, context: Sequence[int], k: int) -> List[int]:
        ...


class NGramDrafter:
    """Model-free prompt-lookup drafting: find the most recent earlier
    occurrence of the context's suffix n-gram (longest n first, down to
    ``min_ngram``) and propose the tokens that followed it.

    Deterministic and host-only: no second model, no device work.  On
    repetitive continuations (greedy cycles, code, quote-heavy answers)
    acceptance approaches 1 and decode emits ~K+1 tokens per forward; on
    novel text it proposes nothing (or drafts verify rejects) and decode
    degenerates gracefully to the single-token path.
    """

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError(
                f"need 1 <= min_ngram ({min_ngram}) <= max_ngram ({max_ngram})"
            )
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram

    def draft(self, context: Sequence[int], k: int) -> List[int]:
        if k <= 0:
            return []
        ctx = list(context)
        length = len(ctx)
        for n in range(min(self.max_ngram, length - 1), self.min_ngram - 1, -1):
            pattern = ctx[length - n:]
            # most recent earlier occurrence wins (recent repetition
            # predicts the continuation better than old)
            for s in range(length - n - 1, -1, -1):
                if ctx[s:s + n] == pattern:
                    cont = ctx[s + n: s + n + k]
                    if cont:
                        return cont
        return []


def _per_offset(knob: torch.Tensor, t: int) -> torch.Tensor:
    """A per-row knob [n] repeated over each row's ``t`` offsets, [n * t]
    (an expand, not ``repeat_interleave``, which may sync)."""
    return knob[:, None].expand(knob.shape[0], t).reshape(-1)


def target_probs(logits, temperature, top_k, top_p) -> torch.Tensor:
    """The verify target distribution p at every offset: [n, T, vocab]
    logits + per-ROW knobs -> filtered, normalized probabilities (fp32).
    Row knobs broadcast over the row's T offsets (one request, one knob
    set, K+1 scored positions)."""
    n, t, vocab = logits.shape
    flat = filter_logits(logits.float().reshape(n * t, vocab), _per_offset(temperature, t),
                         _per_offset(top_k, t), _per_offset(top_p, t))
    return torch.softmax(flat, dim=-1).reshape(n, t, vocab)


def _leading_accepts(ok: torch.Tensor) -> torch.Tensor:
    """Length of the leading all-True prefix per row of a [n, K] bool mask:
    the accepted-draft count (acceptance stops at the first rejection;
    later lucky matches must not count)."""
    return ok.long().cumprod(dim=1).sum(dim=1)


def _emit(drafts, accepted, bonus) -> torch.Tensor:
    """Assemble the emitted-token block [n, K+1]: offsets < accepted carry
    the accepted drafts, offset ``accepted`` the bonus token; later offsets
    repeat the bonus (unread: callers deliver accepted + 1)."""
    n, k = drafts.shape
    ext = torch.cat([drafts, drafts.new_zeros(n, 1)], dim=1)
    iota = torch.arange(k + 1, device=drafts.device)[None, :]
    return torch.where(iota < accepted[:, None], ext, bonus[:, None].to(ext.dtype))


def greedy_verify(drafts, draft_len, targets) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy acceptance: longest draft prefix matching the verify argmax
    chain, plus the argmax at the first mismatch as the bonus token.

    ``drafts`` [n, K] (pads beyond ``draft_len`` ignored), ``targets``
    [n, K+1] = argmax of the verify logits at each offset (``targets[:, i]``
    is the token that FOLLOWS offset ``i``'s input token).  Returns
    ``(tokens [n, K+1], accepted [n])``: ``accepted + 1`` tokens emit per
    row, each the token sequential greedy decode would have produced."""
    n, k = drafts.shape
    iota = torch.arange(k, device=drafts.device)[None, :]
    ok = (drafts == targets[:, :k]) & (iota < draft_len[:, None])
    accepted = _leading_accepts(ok)
    bonus = targets.gather(1, accepted[:, None])[:, 0]
    return _emit(drafts, accepted, bonus), accepted


def rejection_verify(drafts, draft_len, probs,
                     generator: Optional[torch.Generator]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Leviathan rejection sampling for a DETERMINISTIC drafter (q = point
    mass on the draft): accept ``d_i`` with probability ``p_i(d_i)``; at
    the first rejection sample the bonus from the residual ``p_i`` with
    ``d_i`` zeroed, renormalized; with every draft accepted, sample the
    bonus from the next distribution unmodified.

    ``probs`` [n, K+1, vocab] are the filtered target distributions
    (:func:`target_probs`); uniforms and the bonus draw (Gumbel-max) come
    from ``generator``.  The marginal of each emitted token is exactly the
    target distribution.  Returns ``(tokens [n, K+1], accepted [n])``."""
    n, k = drafts.shape
    dev = probs.device
    vocab = probs.shape[-1]
    if k > 0:
        u = torch.rand((n, k), generator=generator, device=dev)
        # a draft outside the vocabulary has probability 0 (JAX's gather
        # fills it), so it is rejected
        in_vocab = (drafts >= 0) & (drafts < vocab)
        p_draft = probs[:, :k, :].gather(-1, drafts.clamp(0, vocab - 1)[..., None].long())[..., 0]
        p_draft = torch.where(in_vocab, p_draft, torch.zeros_like(p_draft))
        iota = torch.arange(k, device=dev)[None, :]
        ok = (u < p_draft) & (iota < draft_len[:, None])
        accepted = _leading_accepts(ok)
    else:
        accepted = torch.zeros(n, dtype=torch.long, device=dev)
    # [n, vocab]: the distribution at the cut
    row_p = probs.gather(1, accepted[:, None, None].expand(n, 1, vocab))[:, 0]
    if k > 0:
        # zero the rejected draft out of the residual, only when the cut
        # IS a rejection (accepted < draft_len), not a fully-accepted block
        # whose bonus draws from the next distribution whole
        rejected = drafts.gather(1, accepted.clamp(0, k - 1)[:, None])[:, 0]
        cut_is_rejection = accepted < draft_len
        mask = torch.arange(vocab, device=dev)[None, :] == rejected[:, None]
        resid = row_p.masked_fill(mask & cut_is_rejection[:, None], 0.0)
        norm = resid.sum(dim=-1, keepdim=True)
        # p(d) ~ 1 makes rejection near-impossible; if rounding still lands
        # here with an empty residual, row_p keeps the sample valid
        row_p = torch.where(norm > 0, resid / norm.clamp(min=1e-30), row_p)
    bonus_logits = torch.where(row_p > 0, row_p.clamp(min=1e-30).log(),
                               torch.full_like(row_p, float("-inf")))
    noise = torch.empty_like(bonus_logits).exponential_(generator=generator)
    bonus = (bonus_logits - noise.log()).argmax(dim=-1)
    return _emit(drafts, accepted, bonus), accepted


def verify_tokens(drafts, draft_len, logits, generator: Optional[torch.Generator], temperature,
                  top_k, top_p,
                  sampled: Optional[bool] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row acceptance over one verify forward's logits [n, K+1, vocab]
    with per-row sampling knobs: greedy rows (``temperature <= 0``) take
    :func:`greedy_verify` on the raw argmax chain, sampled rows
    :func:`rejection_verify` on the filtered target distributions.
    Returns ``(tokens [n, K+1], accepted [n])``; callers emit
    ``accepted + 1`` tokens per row.

    ``sampled`` says whether any row samples.  An all-greedy batch (the
    common serving case) skips the rejection path's ``[n * (K+1), vocab]``
    sorts entirely.  JAX branches on the device; a CUDA graph cannot, so
    the engine decides on the host, where its per-slot temperatures live,
    and captures each variant.  None asks the tensor (one sync)."""
    lf = logits.float()
    g_tokens, g_acc = greedy_verify(drafts, draft_len, lf.argmax(dim=-1))
    if sampled is None:
        sampled = bool((temperature > 0.0).any())
    if not sampled:
        return g_tokens, g_acc
    probs = target_probs(lf, temperature, top_k, top_p)
    s_tokens, s_acc = rejection_verify(drafts, draft_len, probs, generator)
    greedy = temperature <= 0.0
    return (torch.where(greedy[:, None], g_tokens, s_tokens),
            torch.where(greedy, g_acc, s_acc))


def ngram_draft_tokens(history, length, cap, k: int, max_ngram: int = 3,
                       min_ngram: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """DEVICE prompt-lookup drafting: the fixed-shape twin of
    :class:`NGramDrafter`, token for token the same: longest suffix n-gram
    first (``max_ngram`` down to ``min_ngram``), most recent earlier
    occurrence wins, up to ``cap`` following tokens.

    This lets the FUSED spec tick run T draft-verify blocks in one CUDA
    graph: block ``t+1``'s context includes block ``t``'s accepted tokens,
    which live only on the device mid-tick.  Every op has a fixed shape
    over ``[rows, L]`` (no ``nonzero``, boolean indexing or ``.item()``),
    and every index is clamped into ``[0, L-1]`` as JAX clamps its gathers.

    ``history`` [rows, L] holds each row's tokens; ``length`` [rows] its
    live context length (prompt + generated, INCLUDING the current
    unwritten token: the context :meth:`NGramDrafter.draft` sees);
    ``cap`` [rows] the per-row draft budget (``<= 0`` drafts nothing).
    Entries at or beyond ``length`` are never read.  Returns ``(drafts
    [rows, k], dlen [rows])``, drafts zero-padded beyond ``dlen``, the
    host draft block's layout."""
    if k < 1:
        raise ValueError(f"k={k} < 1")
    if not 1 <= min_ngram <= max_ngram:
        raise ValueError(f"need 1 <= min_ngram ({min_ngram}) <= max_ngram ({max_ngram})")
    rows, L = history.shape
    dev = history.device
    length = length.to(torch.long)
    cap = cap.to(torch.long)
    iota = torch.arange(L, device=dev)
    ks = torch.arange(k, device=dev)
    drafts = history.new_zeros(rows, k)
    dlen = torch.zeros(rows, dtype=torch.long, device=dev)
    found = torch.zeros(rows, dtype=torch.bool, device=dev)
    # a static unroll over the (tiny) n-gram size ladder: the largest g
    # with any match wins, as in the host drafter's outer loop
    for g in range(max_ngram, min_ngram - 1, -1):
        ok_g = (cap > 0) & (g <= length - 1)
        gs = torch.arange(g, device=dev)
        sfx = history.gather(1, (length[:, None] - g + gs[None, :]).clamp(0, L - 1))
        match = torch.ones(rows, L, dtype=torch.bool, device=dev)
        for j in range(g):
            shifted = history[:, (iota + j).clamp(max=L - 1)]
            match = match & (shifted == sfx[:, j:j + 1]) & (iota + j < L)[None, :]
        # s <= length - g - 1 keeps the continuation nonempty
        match = match & (iota[None, :] <= (length - g - 1)[:, None]) & ok_g[:, None]
        s = torch.where(match, iota[None, :], torch.full_like(match, -1, dtype=torch.long)
                        ).amax(dim=-1)
        hit = s >= 0
        cont = history.gather(1, (s[:, None] + g + ks[None, :]).clamp(0, L - 1))
        take = torch.where(hit, torch.minimum(cap, length - (s + g)), torch.zeros_like(s))
        use = hit & ~found
        drafts = torch.where(use[:, None], cont, drafts)
        dlen = torch.where(use, take, dlen)
        found = found | hit
    # zero-pad beyond dlen: the host block layout (zeros + fill)
    drafts = torch.where(ks[None, :] < dlen[:, None], drafts, torch.zeros_like(drafts))
    return drafts, dlen


def adapt_draft_len_traced(k, drafted, accepted, k_max) -> torch.Tensor:
    """Tensor :func:`adapt_draft_len` (k_min fixed at 1): the fused spec
    tick's in-graph per-slot adaptation, the same grow/shrink law, so the
    fused and per-step engines ride identical draft-length trajectories."""
    grown = torch.minimum(k + 1, k_max)
    shrunk = (accepted + 1).clamp(min=1)
    adapted = torch.where(accepted >= drafted, grown, shrunk)
    return torch.where(drafted <= 0, k, adapted)


def draft_for_row(drafter: Drafter, context: Sequence[int], k_eff: int, write_index: int,
                  seq_len: int, remaining: int) -> List[int]:
    """One row's draft block, safety-capped: THE shared clamp of the
    engine's spec tick and :func:`generate_speculative`.

    The cap is correctness-critical on two sides: ``seq_len - 1 - widx``
    keeps every REAL draft's cache write in range (a dropped write would
    silently lose a scored position), and ``remaining - 1`` keeps a block
    (accepted + bonus) from overshooting the request's token budget.
    Returns at most ``k_eff`` drafted tokens, possibly none."""
    cap = min(int(k_eff), seq_len - 1 - int(write_index), remaining - 1)
    if cap <= 0:
        return []
    return list(drafter.draft(context, cap))[:cap]


def adapt_draft_len(k: int, drafted: int, accepted: int, k_max: int, k_min: int = 1) -> int:
    """Acceptance-adaptive draft length: grow by one after a fully-accepted
    block, shrink to just past the acceptance point otherwise.  Bounded in
    [k_min, k_max]; a tick that drafted nothing teaches nothing.  The
    verify shape never changes (every block pads to the engine's K_max
    width); adaptation only trims how many real drafts ride it."""
    if drafted <= 0:
        return k
    if accepted >= drafted:
        return min(k + 1, k_max)
    return max(k_min, accepted + 1)


@torch.inference_mode()
def generate_speculative(model, prompt, generator: Optional[torch.Generator] = None, *,
                         max_new_tokens: int = 32, draft_tokens: int = 4,
                         drafter: Optional[Drafter] = None, adaptive: bool = True,
                         temperature: float = 0.0, top_k: int = 0, top_p: float = 0.0,
                         return_stats: bool = False, registry=None):
    """Standalone batch speculative decoding with ``generate()``'s contract
    (returns [batch, max_new_tokens]; greedy output is token-identical)
    through draft-verify ticks instead of single-token steps.

    The loop is host-side (the drafter reads token histories in Python):
    one verify forward + acceptance per tick through the engine's own
    functions (``engine._prefill_core``, ``_verify_core``,
    ``sample_tokens``).  ``draft_tokens=0`` degenerates to the per-token
    host loop.  Rows finish at their own tick; finished rows park their
    cache writes out of range as the engine's freed slots do.

    With ``return_stats`` also returns ``{"ticks", "drafted", "accepted",
    "acceptance_rate", "tokens_per_tick"}``.  ``registry`` (a
    :class:`~tpu_parallel_torch.obs.registry.MetricRegistry`) observes
    each row-tick's acceptance fraction into the engine's
    ``serving_spec_acceptance_ratio`` histogram."""
    from tpu_parallel_torch.serving.engine import _prefill_core, _verify_core, sample_tokens

    cfg = model.config
    if prompt.device != model.device:
        raise ValueError(f"prompt is on {prompt.device}, the model on {model.device}")
    b, prompt_len = prompt.shape
    if prompt_len + max_new_tokens > cfg.seq_len:
        raise ValueError(
            f"prompt ({prompt_len}) + max_new_tokens ({max_new_tokens}) "
            f"exceeds seq_len ({cfg.seq_len})"
        )
    if draft_tokens < 0:
        raise ValueError(f"draft_tokens={draft_tokens} < 0")
    dev = model.device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if drafter is None:
        drafter = NGramDrafter()

    temp = torch.full((b,), float(temperature), device=dev)
    tk = torch.full((b,), int(top_k), dtype=torch.long, device=dev)
    tp = torch.full((b,), float(top_p), device=dev)
    positions = torch.arange(prompt_len, device=dev).expand(b, prompt_len)
    logits, cache = _prefill_core(model, prompt.long(), positions,
                                  torch.full((b,), prompt_len - 1, device=dev))
    first = sample_tokens(logits, generator, temp, tk, tp).cpu().numpy()
    prompts_host = [[int(t) for t in row] for row in prompt.cpu().numpy()]
    out: List[List[int]] = [[int(first[r])] for r in range(b)]
    tok = first.astype(np.int64)
    pos = np.full(b, prompt_len, np.int64)
    widx = np.full(b, prompt_len, np.int64)
    kmax = draft_tokens
    k_eff = np.full(b, max(kmax, 0), np.int64)
    ticks = drafted_total = accepted_total = 0
    acceptance_hist = (registry.histogram("serving_spec_acceptance_ratio")
                       if registry is not None else None)
    as_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    while any(len(t) < max_new_tokens for t in out):
        drafts = np.zeros((b, kmax), np.int64)
        dlen = np.zeros(b, np.int64)
        for r in range(b):
            rem = max_new_tokens - len(out[r])
            if rem <= 0:
                widx[r] = cfg.seq_len  # park: finished rows write nothing
                continue
            d = draft_for_row(drafter, prompts_host[r] + out[r], int(k_eff[r]), int(widx[r]),
                              cfg.seq_len, rem)
            dlen[r] = len(d)
            drafts[r, :len(d)] = d
        block, accepted = _verify_core(
            model, as_dev(tok), as_dev(drafts), as_dev(dlen), as_dev(pos), as_dev(widx), temp,
            tk, tp, cache, generator, sampled=temperature > 0.0)
        # one sync per verify tick
        block, accepted = block.cpu().numpy(), accepted.cpu().numpy()
        ticks += 1
        for r in range(b):
            if len(out[r]) >= max_new_tokens:
                continue
            a = int(accepted[r])
            out[r].extend(int(t) for t in block[r, :a + 1])
            tok[r] = int(block[r, a])
            pos[r] += a + 1
            widx[r] += a + 1
            drafted_total += int(dlen[r])
            accepted_total += a
            if acceptance_hist is not None and int(dlen[r]) > 0:
                acceptance_hist.observe(a / int(dlen[r]))
            if adaptive and kmax > 0:
                k_eff[r] = adapt_draft_len(int(k_eff[r]), int(dlen[r]), a, kmax)
    tokens = torch.tensor([row[:max_new_tokens] for row in out], dtype=torch.long, device=dev)
    if not return_stats:
        return tokens
    # tokens emitted BY verify ticks (each row's first came from the prefill)
    emitted = int(sum(len(row[:max_new_tokens]) for row in out)) - b
    stats = {
        "ticks": ticks,
        "drafted": drafted_total,
        "accepted": accepted_total,
        "acceptance_rate": (round(accepted_total / drafted_total, 4) if drafted_total
                            else None),
        "tokens_per_tick": round(emitted / max(ticks, 1), 3),
    }
    return tokens, stats
