"""Autoregressive generation with a KV cache: the port of
``tpu_parallel/models/generate.py``.

A prefill over the prompt fills every layer's cache, then a Python loop of
single-token decode steps appends to it and attends the cached prefix.  The
cache is updated in place.  Sampling draws from an explicit
``torch.Generator`` (it will not give the JAX package's random bits: only
greedy decoding is comparable token for token).  :func:`generate_beam` is
beam search, lazy (per-slot source-row tables) or eager (the cache
reordered every step).  Every entry point takes either cache dtype
(``kv_cache_dtype`` "bf16" or "int8").  A mesh-trained state serves through
``export_single_device_params`` (re-exported from ``parallel/tp.py``).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from tpu_parallel_torch.models.gpt import GPTLM
from tpu_parallel_torch.models.layers import KVCache
from tpu_parallel_torch.parallel.tp import export_single_device_params  # noqa: F401  (re-export: mesh-trained state -> generate-able params)


def _sample(logits, generator: Optional[torch.Generator], temperature: float,
            top_k: int, top_p: float = 0.0) -> torch.Tensor:
    """One token per row from [batch, vocab] logits, in fp32.

    ``temperature == 0`` is greedy.  ``top_k`` keeps the k highest logits;
    ``top_p`` in (0, 1) keeps the smallest prefix of the sorted distribution
    whose mass reaches p (the argmax always survives).  Both filters compose
    and apply after the temperature scale.
    """
    logits = logits.float()
    if temperature == 0.0:
        return logits.argmax(dim=-1)
    logits = logits / temperature
    if top_k > 0:
        kth = logits.topk(top_k, dim=-1).values[:, -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if 0.0 < top_p < 1.0:
        desc = logits.sort(dim=-1, descending=True).values
        probs = torch.softmax(desc, dim=-1)
        # keep tokens whose mass BEFORE them is < p (so top-1 always stays)
        keep = probs.cumsum(dim=-1) - probs < top_p
        cutoff = torch.where(keep, desc, torch.full_like(desc, float("inf")))
        cutoff = cutoff.amin(dim=-1, keepdim=True)
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def decode_step(model: GPTLM, cache: List[KVCache], tok, positions, write_index=None,
                block_table=None):
    """One single-token decode tick.  ``tok``/``positions``: [batch] current
    tokens and their global positions.  ``write_index`` [batch] (the serving
    engine's slot pool) writes row r's K/V at its own column
    ``write_index[r]`` (out-of-range columns are dropped); without it the
    step writes at the cache's scalar index.  ``block_table`` routes the
    reads and writes through a paged pool (:class:`PagedKVCache`).  Returns
    ``(hidden [batch, 1, d_model], cache)``; the cache is the same object,
    updated in place."""
    hidden = model(tok[:, None], positions=positions[:, None], decode=True,
                   hidden_only=True, cache=cache, write_index=write_index,
                   block_table=block_table)
    return hidden, cache


def padded_prefill_inputs(lengths, width: int, device=None):
    """RIGHT-padded prefill positions for prompts of ``lengths`` in a
    ``width``-wide bucket: real tokens get 0..len-1, pad slots -1.  Returns
    ``(positions [b, width] int32, last_idx [b] int32)``."""
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=device)
    iota = torch.arange(width, dtype=torch.int32, device=lengths.device)[None, :]
    positions = torch.where(iota < lengths[:, None], iota, torch.full_like(iota, -1))
    return positions, lengths - 1


def prefill_step(model: GPTLM, tokens, positions) -> Tuple[torch.Tensor, List[KVCache]]:
    """Fresh-cache prefill over ``tokens`` [b, P] at explicit ``positions``
    [b, P] (pads -1: written to the cache's position table, never attended).
    Returns ``(hidden [b, P, d_model], cache)``."""
    cache = model.init_cache(tokens.shape[0])
    hidden = model(tokens, positions=positions, decode=True, hidden_only=True, cache=cache)
    return hidden, cache


def prefill_extend_step(model: GPTLM, cache: List[KVCache], tokens, positions,
                        write_start, block_table=None) -> Tuple[torch.Tensor, List[KVCache]]:
    """Continue a prefill INTO an existing cache: ``tokens`` [b, T] at
    global ``positions`` [b, T] (pads -1), K/V written at columns
    ``write_start + [0..T)`` per row.  Each chunk attends the cached prefix
    and itself through the stored positions, so chunks give the same
    values as one monolithic prefill.  The chunked-prefill and prefix-reuse
    core of the serving engine; with ``block_table`` the writes land in a
    paged pool through each row's table (the paged admission and the
    unified tick's chunk phase, where rows that are not prefilling ride
    along all-pad with ``write_start`` at ``seq_len``).  Returns
    ``(hidden [b, T, d_model], cache)``, the cache updated in place."""
    hidden = model(tokens, positions=positions, decode=True, hidden_only=True,
                   cache=cache, write_index=write_start, block_table=block_table)
    return hidden, cache


def verify_step(model: GPTLM, cache: List[KVCache], tokens, positions, write_index,
                block_table=None) -> Tuple[torch.Tensor, List[KVCache]]:
    """Score T tokens per row in ONE forward: the speculative-decoding
    verify core.  ``tokens`` [b, T] is each row's current token followed by
    its draft tokens, at global ``positions`` [b, T] (pads -1); K/V land at
    columns ``write_index + [0..T)`` per row (through each row's table with
    ``block_table``), the multi-token write path chunked prefill uses.

    Each token's attention reads the post-write cache and masks by STORED
    positions, so position ``p + i`` attends the prefix plus the drafts
    before it: the returned ``hidden`` [b, T, d_model] gives the next-token
    distribution of every draft offset in one pass, as ``i`` sequential
    :func:`decode_step` calls would.  Rejected drafts need no rollback:
    their columns lie beyond the accepted frontier, at positions greater
    than any query's until a later verify overwrites them, and pad offsets
    write -1 (never attended).  The cache is updated in place."""
    hidden = model(tokens, positions=positions, decode=True, hidden_only=True,
                   cache=cache, write_index=write_index, block_table=block_table)
    return hidden, cache


def _generate_core(model: GPTLM, prompt, generator, max_new_tokens: int,
                   temperature: float, top_k: int, top_p: float = 0.0,
                   prompt_mask=None) -> torch.Tensor:
    """Prefill then decode loop.  The lm_head reads only each step's last
    position.  ``prompt_mask`` [b, P] serves RAGGED batches: rows LEFT-padded
    (False at the left), each continuing from its own length."""
    cfg = model.config
    b, prompt_len = prompt.shape
    if prompt_len + max_new_tokens > cfg.seq_len:
        raise ValueError(
            f"prompt ({prompt_len}) + max_new_tokens ({max_new_tokens}) "
            f"exceeds seq_len ({cfg.seq_len})"
        )

    def next_token(hidden):
        return _sample(model.lm_head(hidden[:, -1]), generator, temperature, top_k, top_p)

    if prompt_mask is None:
        positions = torch.arange(prompt_len, device=prompt.device).expand(b, prompt_len)
        lengths = torch.full((b,), prompt_len, dtype=torch.long, device=prompt.device)
    else:
        if tuple(prompt_mask.shape) != tuple(prompt.shape):
            raise ValueError(
                f"prompt_mask shape {tuple(prompt_mask.shape)} != prompt shape "
                f"{tuple(prompt.shape)}"
            )
        m = prompt_mask.long()
        positions = torch.where(m > 0, m.cumsum(dim=1) - 1, torch.full_like(m, -1))
        lengths = m.sum(dim=1)
    hidden, cache = prefill_step(model, prompt, positions)
    tok = next_token(hidden)
    out = [tok]
    pos = lengths
    for _ in range(max_new_tokens - 1):
        hidden, cache = decode_step(model, cache, tok, pos)
        tok = next_token(hidden)
        out.append(tok)
        pos = pos + 1
    return torch.stack(out, dim=1)


@torch.inference_mode()
def generate(model: GPTLM, prompt, generator: Optional[torch.Generator] = None, *,
             max_new_tokens: int = 32, temperature: float = 0.0, top_k: int = 0,
             top_p: float = 0.0, prompt_mask=None) -> torch.Tensor:
    """Generate ``max_new_tokens`` continuations of ``prompt`` [batch, P].

    Returns the continuation only, [batch, max_new_tokens] (greedy when
    ``temperature == 0``).  ``prompt`` (and ``prompt_mask``) must be on the
    model's device; ``generator`` too, and defaults to one seeded with 0.
    """
    if prompt.device != model.device:
        raise ValueError(f"prompt is on {prompt.device}, the model on {model.device}")
    if generator is None:
        generator = torch.Generator(device=model.device).manual_seed(0)
    return _generate_core(
        model, prompt, generator, max_new_tokens, temperature, top_k, top_p,
        prompt_mask=prompt_mask,
    )


# --- beam search --------------------------------------------------------------
#
# The JAX package locates each cache leaf's batch axis by name
# (``beam_cache_batch_axis``) to reorder a flax cache collection; the port's
# counterpart is :meth:`KVCache.take_rows`, which gathers every payload,
# scale and position store of a layer's cache along its batch axis.


def beam_expand_cache(cache: List[KVCache], k: int) -> List[KVCache]:
    """Replicate every batch row ``k`` ways (beam j of row i = row i*k+j):
    new caches, the scalar index kept."""
    rows = torch.arange(cache[0].batch, device=cache[0].pos_store.device).repeat_interleave(k)
    return [c.take_rows(rows) for c in cache]


def beam_seed_src(cache: List[KVCache], num_beams: int) -> List[KVCache]:
    """Give every layer's cache an identity ``beam_src`` table (lazy beam
    search): ``beam_src[row, slot]`` names the row whose cache physically
    holds that slot of this row's beam history.  Identity is right after
    the prefill: every beam of a prompt holds the same replicated slots."""
    for c in cache:
        c.seed_beam_src(num_beams)
    return cache


def beam_advance_src(cache: List[KVCache], row_idx) -> List[KVCache]:
    """Lazy-beam step update: row-gather every ``beam_src`` table by the
    winning beams' parent rows (``new[r'] = old[parent(r')]``).  The K/V
    stores are NOT touched; the slot written this step already maps to the
    writing row (the layer keeps that invariant), so the gather alone keeps
    the table exact."""
    for c in cache:
        c.beam_src = c.beam_src.index_select(0, row_idx)
    return cache


def beam_reorder_cache(cache: List[KVCache], row_idx) -> List[KVCache]:
    """The eager form: new caches whose rows follow their winning beams,
    one ``index_select`` of every payload, scale and position store along
    the batch axis (the whole cache read and written per step)."""
    return [c.take_rows(row_idx) for c in cache]


def beam_backtrack(first, toks, src_beams, scores) -> torch.Tensor:
    """Follow each row's best final beam back through the per-step
    (token, source-beam) records ``toks``/``src_beams`` [T-1, batch, k]
    (``first`` [batch, k]: the first step's tokens); returns [batch, T]
    token ids."""
    beam = scores.argmax(dim=-1)[:, None]
    rev = []
    for t in range(toks.shape[0] - 1, -1, -1):
        rev.append(toks[t].gather(1, beam)[:, 0])
        beam = src_beams[t].gather(1, beam)
    return torch.stack([first.gather(1, beam)[:, 0]] + rev[::-1], dim=1)


def _top_k(x, k: int):
    """The ``k`` largest entries along the last axis, in descending order
    with the lower index first among equal values (``lax.top_k``'s order;
    ``torch.topk`` does not promise one): a stable descending sort."""
    values, index = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], index[..., :k]


@torch.inference_mode()
def generate_beam(model: GPTLM, prompt, *, max_new_tokens: int = 32, num_beams: int = 4,
                  length_penalty: float = 0.0, lazy: bool = True):
    """Beam-search decoding: the highest-scoring continuation per prompt row.

    Returns ``(tokens [batch, max_new_tokens], scores [batch])``, ``scores``
    the winning beam's total log-probability divided by
    ``max_new_tokens ** length_penalty`` (0: pure log-prob, 1: per-token
    mean).  The prefill runs once per prompt row on the plain model; its
    cache is then replicated ``num_beams`` ways (beam j of prompt i is row
    ``i * num_beams + j``) and each step takes the top ``num_beams`` of the
    ``num_beams * vocab`` joint continuations per prompt.  ``lazy=True``
    follows beam ancestry through per-slot source-row tables and
    :func:`~tpu_parallel_torch.models.layers.beam_decode_attention` (the
    cache is never re-gathered); ``lazy=False`` reorders every layer's
    cache rows each step.  Fixed-length decoding, no EOS handling, as
    :func:`generate`.  ``prompt`` must be on the model's device.
    """
    cfg = model.config
    if prompt.device != model.device:
        raise ValueError(f"prompt is on {prompt.device}, the model on {model.device}")
    b, prompt_len = prompt.shape
    if prompt_len + max_new_tokens > cfg.seq_len:
        raise ValueError(
            f"prompt ({prompt_len}) + max_new_tokens ({max_new_tokens}) "
            f"exceeds seq_len ({cfg.seq_len})"
        )
    k = num_beams
    vocab = cfg.vocab_size
    dev = prompt.device
    positions = torch.arange(prompt_len, device=dev).expand(b, prompt_len)
    cache = model.init_cache(b, beam_width=0)
    hidden = model(prompt, positions=positions, decode=True, hidden_only=True, cache=cache)
    first_logp = torch.log_softmax(model.lm_head(hidden[:, -1]).float(), dim=-1)
    scores, first = _top_k(first_logp, k)  # [b, k] each
    cache = beam_expand_cache(cache, k)
    if lazy:
        beam_seed_src(cache, k)
    tok = first.reshape(b * k)
    offsets = torch.arange(b, device=dev)[:, None] * k
    toks, srcs = [], []
    for step in range(max_new_tokens - 1):
        pos = torch.full((b * k,), prompt_len + step, device=dev)
        hidden, cache = decode_step(model, cache, tok, pos)
        logp = torch.log_softmax(model.lm_head(hidden[:, -1]).float(), dim=-1)
        # joint scores over (beam, next token) per prompt row
        joint = scores[:, :, None] + logp.view(b, k, vocab)
        scores, flat = _top_k(joint.view(b, k * vocab), k)
        src_beam = flat // vocab  # [b, k] originating beam per winner
        next_tok = flat % vocab
        row_idx = (src_beam + offsets).reshape(b * k)
        if lazy:
            cache = beam_advance_src(cache, row_idx)
        else:
            cache = beam_reorder_cache(cache, row_idx)
        tok = next_tok.reshape(b * k)
        toks.append(next_tok)
        srcs.append(src_beam)
    if toks:
        toks, srcs = torch.stack(toks), torch.stack(srcs)
    else:
        toks = srcs = first.new_zeros((0, b, k))
    out = beam_backtrack(first, toks, srcs, scores)
    best = scores.max(dim=-1).values
    if length_penalty:
        best = best / torch.tensor(float(max_new_tokens), device=dev) ** length_penalty
    return out, best
