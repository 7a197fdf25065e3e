"""Port parity: the encoder-decoder family (``models/seq2seq.py``: the
``EncoderDecoder``, ``CrossAttention`` over a cached memory, the
teacher-forced loss, greedy, sharded and beam decoding) and the T5
relative position bias (on ``EncoderDecoder`` and ``GPTLM``) against the
JAX package.

Mirrors ``tests/test_seq2seq.py`` case for case on bridged
``tiny_seq2seq`` / ``tiny_test`` weights (fp32, CPU; JAX on its xla path):
causality, visibility of the source, source padding, greedy decoding
against teacher forcing, the scanned and unrolled layouts, the loss
without a mesh, eval without a dropout generator, the refusals in JAX's
words, and beam search (lazy and eager).  The mesh cases run once, in one
8-rank gloo group (``tests/torch_dp_worker.py``, suite ``seq2seq``): the
Trainer over data=8 (DP and FSDP), data 4 x model 2 (TP, the MoE over the
model axis), data 2 x seq 4 (ring and Ulysses) and data 2 x pipe 4 (two
GPipe passes), each rank's synced step-1 gradients against JAX's
one-device gradients of the same objective, then falling losses; the
vocab-parallel CE, sharded decoding (against the exported weights, the
TP state's own teacher forcing and JAX's tokens on the same weights), SP
against dense, the Trainer's seq2seq family, the mesh-bound refusals and
``tests/test_generate.py:711``'s relative-bias ``generate_sharded``.
Beside them: the bucket table exactly JAX's, ``tiny_test`` with the
relative bias (forward, loss, gradients, tokens), the T5-shaped variant,
the flash path's plain versions over padded sources, the cross cache
written once, ``seq2seq_batch``, and the relative refusals of the
generator and the engine.

Tolerances (fp32): outputs and logits 1e-5 (rtol and atol); gradients
rtol 1e-4, atol 1e-6; losses rtol 1e-5; trees and round trips bitwise;
greedy and beam tokens exactly.  JAX is imported inside the fixtures, so
the ``gpu`` case runs on the card with ``--noconftest``.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch
from torch_dp_worker import S2S_GEN, S2S_STEPS, S2S_TRAIN, flat_tree, run_once

from tpu_parallel_torch.models import GPTLM, layers, tiny_test
from tpu_parallel_torch.models.convert import params_from_jax, params_to_jax
from tpu_parallel_torch.models.seq2seq import (EncoderDecoder, Seq2SeqBatch, make_seq2seq_loss,
                                               seq2seq_generate, seq2seq_generate_beam,
                                               tiny_seq2seq)

torch.set_num_threads(1)

NUM_RANKS = 8
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
T5ISH = dict(positional="relative", norm="rmsnorm", norm_eps=1e-6, dense_bias=False, mlp="relu")


@pytest.fixture(scope="module")
def jx():
    """The JAX package's side."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from tpu_parallel.models import gpt as jgpt
    from tpu_parallel.models import layers as jlayers
    from tpu_parallel.models import seq2seq as js

    return types.SimpleNamespace(jax=jax, jnp=jnp, gpt=jgpt, layers=jlayers, s2s=js, cache={})


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree)


def _port(x):
    return torch.from_numpy(np.array(x))


def _to_jax(jx, module, config=None):
    return jx.jax.tree.map(lambda t: jx.jnp.asarray(t.float().numpy()),
                           params_to_jax(module.state_dict(), config or module.config))


def _bridged(jx, seed=0, **overrides):
    """(JAX model, its params as JAX's tree, the port's model): the port's
    seeded fp32 init of ``tiny_seq2seq(**overrides)``, unrolled."""
    overrides = {"scan_layers": False, **overrides}
    model = EncoderDecoder(tiny_seq2seq(**overrides), device="cpu", seed=seed).eval()
    jm = jx.s2s.EncoderDecoder(jx.s2s.tiny_seq2seq(remat=False, **overrides))
    return jm, _to_jax(jx, model), model


def _tokens(shape, seed, low=0):
    return np.random.default_rng(seed).integers(low, 256, shape).astype(np.int32)


@pytest.fixture(scope="module")
def tiny(jx):
    jm, params, model = _bridged(jx)
    return jm, params, model, _tokens((2, 16), 1), _tokens((2, 8), 2)


def _logits(model, src, dst, mask=None):
    with torch.no_grad():
        return model(_port(src).long(), _port(dst).long(),
                     None if mask is None else _port(mask)).numpy()


def _japply(jx, jm, params, src, dst, mask=None):
    """JAX's eval forward, one jitted function per model (its ops compiled
    together: eager flax would compile each op on its own)."""
    key = ("apply", jm.config)
    if key not in jx.cache:
        jx.cache[key] = jx.jax.jit(lambda p, s, d, m: jm.apply({"params": p}, s, d, src_mask=m,
                                                               train=False))
    if mask is None:
        mask = np.ones(np.shape(src), bool)
    return np.asarray(jx.cache[key](params, jx.jnp.asarray(src), jx.jnp.asarray(dst),
                                    jx.jnp.asarray(mask)))


def _grads(model, loss):
    model.zero_grad()
    loss.backward()
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def _assert_grads(got, jax_grads, cfg):
    want = params_from_jax(_np(jax_grads), cfg, dtype=torch.float32)
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        np.testing.assert_allclose(np.asarray(got[key]), value.numpy(), **GRAD_TOL, err_msg=key)


def _copy_batch(rows, length, seed=0):
    """tests/test_seq2seq.py's copy task: the target reproduces the source."""
    src = _tokens((rows, length), seed, low=2)
    tokens = np.concatenate([np.ones((rows, 1), np.int32), src[:, :-1]], axis=1)
    return dict(src_tokens=src, tokens=tokens, targets=src, src_mask=np.ones(src.shape, bool))


def _port_batch(b):
    return Seq2SeqBatch(src_tokens=_port(b["src_tokens"]).long(), tokens=_port(b["tokens"]).long(),
                        targets=_port(b["targets"]).long(), src_mask=_port(b["src_mask"]))


def _jax_batch(jx, b):
    return jx.s2s.Seq2SeqBatch(**{k: jx.jnp.asarray(v) for k, v in b.items()})


def _forced(toks):
    return np.concatenate([np.ones((toks.shape[0], 1), np.int32), toks[:, :-1]], axis=1)


# -- one device: tests/test_seq2seq.py ---------------------------------------


def test_forward_shapes(jx, tiny):
    jm, params, model, src, dst = tiny
    got = _logits(model, src, dst)
    assert got.shape == (2, 8, 256)
    np.testing.assert_allclose(got, _japply(jx, jm, params, src, dst), **TOL)


def test_decoder_is_causal(jx, tiny):
    """Perturbing a future decoder token leaves earlier logits unchanged."""
    jm, params, model, src, dst = tiny
    dst2 = dst.copy()
    dst2[:, 5] = (dst2[:, 5] + 1) % 256
    base, pert = _logits(model, src, dst), _logits(model, src, dst2)
    np.testing.assert_allclose(base[:, :5], pert[:, :5], atol=1e-5)
    assert not np.allclose(base[:, 5:], pert[:, 5:])
    np.testing.assert_allclose(pert, _japply(jx, jm, params, src, dst2), **TOL)


def test_every_position_sees_source(jx, tiny):
    """A source perturbation reaches every decoder position."""
    jm, params, model, src, dst = tiny
    src2 = src.copy()
    src2[:, 3] = (src2[:, 3] + 1) % 256
    pert = _logits(model, src2, dst)
    diff = np.abs(_logits(model, src, dst) - pert).max(axis=(0, 2))
    assert (diff > 0).all(), diff
    np.testing.assert_allclose(pert, _japply(jx, jm, params, src2, dst), **TOL)


def test_source_padding_masked(jx, tiny):
    """Masked source positions move nothing, through the encoder's
    attention or the cross-attention."""
    jm, params, model, src, dst = tiny
    mask = np.ones((2, 16), bool)
    mask[:, 12:] = False
    src2 = src.copy()
    src2[:, 12:] = 7
    a, b = _logits(model, src, dst, mask), _logits(model, src2, dst, mask)
    np.testing.assert_allclose(a, b, atol=1e-5)
    np.testing.assert_allclose(a, _japply(jx, jm, params, src, dst, mask), **TOL)


def test_generate_matches_teacher_forcing(jx, tiny):
    """Cached decoding (self cache, cross cache, position counter) emits the
    greedy path of the teacher-forced forward, and JAX's tokens."""
    jm, params, model, src, _ = tiny
    toks = seq2seq_generate(model, _port(src).long(), max_new_tokens=6, bos_id=1).numpy()
    ref = _logits(model, src, _forced(toks)).argmax(-1)
    np.testing.assert_array_equal(toks, ref)
    want = jx.s2s.seq2seq_generate(jm, params, jx.jnp.asarray(src), max_new_tokens=6, bos_id=1)
    np.testing.assert_array_equal(toks, np.asarray(want))


def test_scan_matches_unrolled(jx):
    """JAX's scanned and unrolled trees of one set of weights give the port
    the same state dict bitwise (both bridges), hence the same function;
    the scanned tree's logits are JAX's."""
    model = EncoderDecoder(tiny_seq2seq(scan_layers=True, remat=False), device="cpu", seed=3)
    cfg_s, cfg_l = model.config, tiny_seq2seq(scan_layers=False)
    scanned = params_to_jax(model.state_dict(), cfg_s)
    assert "layers" in scanned["encoder"] and "layers" in scanned["decoder"]
    from_scanned = params_from_jax(scanned, cfg_s)
    from_unrolled = params_from_jax(params_to_jax(model.state_dict(), cfg_l), cfg_l)
    for key, value in model.state_dict().items():
        assert torch.equal(from_scanned[key], value) and torch.equal(from_unrolled[key], value)
    src, dst = _tokens((2, 16), 1), _tokens((2, 8), 2)
    jm = jx.s2s.EncoderDecoder(jx.s2s.tiny_seq2seq(scan_layers=True, remat=False))
    tree = jx.jax.tree.map(lambda t: jx.jnp.asarray(t.numpy()), scanned)
    np.testing.assert_allclose(_logits(model.eval(), src, dst),
                               _japply(jx, jm, tree, src, dst), rtol=1e-4, atol=1e-4)


def test_loss_runs_without_mesh(jx):
    """The loss without a mesh: JAX's loss, token count and gradients."""
    jm, params, model = _bridged(jx, seed=4)
    b = _copy_batch(4, 16)
    b["src_mask"][1, 10:] = False
    loss_mask = np.ones((4, 16), np.float32)
    loss_mask[2, 12:] = 0
    jax = jx.jax
    jb = jx.s2s.Seq2SeqBatch(**{k: jx.jnp.asarray(v) for k, v in b.items()},
                             loss_mask=jx.jnp.asarray(loss_mask))
    jloss_fn = jx.s2s.make_seq2seq_loss(jm.config)
    (jloss, jm_metrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jloss_fn(p, jm.apply, jb, jax.random.PRNGKey(1)), has_aux=True))(params)
    batch = dataclasses.replace(_port_batch(b), loss_mask=_port(loss_mask))
    loss, metrics = make_seq2seq_loss(model.config)(model.train(), batch,
                                                    torch.Generator().manual_seed(0))
    assert np.isfinite(loss.item())
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert float(metrics["loss"][1]) == float(jm_metrics["loss"][1]) == loss_mask.sum()
    _assert_grads(_grads(model, loss), jgrads, model.config)


def test_eval_forward_needs_no_dropout_rng():
    """train=False turns every dropout off (cross-attention's too): two eval
    forwards without a generator agree; training asks for one."""
    model = EncoderDecoder(tiny_seq2seq(dropout_rate=0.1), device="cpu", seed=0)
    src, dst = torch.zeros(1, 8, dtype=torch.long), torch.zeros(1, 4, dtype=torch.long)
    with torch.no_grad():
        assert torch.equal(model(src, dst), model(src, dst))
        with pytest.raises(ValueError, match="rng"):
            model(src, dst, train=True)
        a = model(src, dst, train=True, rng=torch.Generator().manual_seed(1))
        b = model(src, dst, train=True, rng=torch.Generator().manual_seed(2))
    assert not torch.equal(a, b)


def test_refusals_are_loud(jx):
    """JAX's construction-time refusals, in its words."""
    jax, jnp = jx.jax, jx.jnp
    src = jnp.zeros((1, 8), jnp.int32)
    for bad, kind in ((dict(moe_experts=2, pipe_size=2), NotImplementedError),
                      (dict(prenorm=False), NotImplementedError),
                      (dict(embed_norm=True), NotImplementedError),
                      (dict(pipe_size=2, pipe_interleave=2), NotImplementedError),
                      (dict(pipe_interleave=2), ValueError)):
        with pytest.raises(kind) as want:
            jx.s2s.EncoderDecoder(jx.s2s.tiny_seq2seq(**bad)).init(
                {"params": jax.random.PRNGKey(0)}, src, src, train=False)
        with pytest.raises(kind) as got:
            EncoderDecoder(tiny_seq2seq(**bad), device="cpu")
        assert str(got.value) == str(want.value), bad
    with pytest.raises(NotImplementedError) as want:
        jx.s2s.EncoderDecoder(jx.s2s.tiny_seq2seq(positional="relative", attn_impl="flash")).init(
            {"params": jax.random.PRNGKey(0)}, src, src, train=False)
    with pytest.raises(NotImplementedError) as got:
        EncoderDecoder(tiny_seq2seq(positional="relative", attn_impl="flash"), device="cpu")
    assert str(got.value) == str(want.value)
    # the cross-attention's two errors: no memory outside decode, a decode
    # step before the prefill
    model = EncoderDecoder(tiny_seq2seq(), device="cpu")
    dst = torch.zeros(1, 4, dtype=torch.long)
    with pytest.raises(ValueError, match="needs `memory` outside decode"):
        model.decode(dst, None)
    with pytest.raises(ValueError, match="decode step before prefill"):
        model.decode(dst, None, decode=True, cache=model.init_cache(1))
    with pytest.raises(ValueError, match="exceeds decoder seq_len"):
        seq2seq_generate(model, torch.zeros(1, 8, dtype=torch.long), max_new_tokens=33)
    with pytest.raises(ValueError, match="exceeds the encoder's source_len"):
        seq2seq_generate(model, torch.zeros(1, 40, dtype=torch.long), max_new_tokens=2)


def test_beam_search_beats_or_matches_greedy(jx, tiny):
    """One beam is greedy; each returned score is the teacher-forced
    log-probability of its tokens; the tokens are JAX's."""
    jm, params, model, src, _ = tiny
    s = _port(src).long()
    greedy = seq2seq_generate(model, s, max_new_tokens=6, bos_id=1)
    beam1, s1 = seq2seq_generate_beam(model, s, bos_id=1, max_new_tokens=6, num_beams=1)
    assert torch.equal(beam1, greedy)
    beam4, s4 = seq2seq_generate_beam(model, s, bos_id=1, max_new_tokens=6, num_beams=4)

    def seq_logp(tokens):
        logits = torch.from_numpy(_logits(model, src, _forced(tokens.numpy())))
        lp = torch.log_softmax(logits.float(), -1)
        return lp.gather(-1, tokens[..., None])[..., 0].sum(-1)

    np.testing.assert_allclose(s1.numpy(), seq_logp(beam1).numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(s4.numpy(), seq_logp(beam4).numpy(), rtol=1e-4, atol=1e-4)
    jt, js_ = jx.s2s.seq2seq_generate_beam(jm, params, jx.jnp.asarray(src), bos_id=1,
                                           max_new_tokens=6, num_beams=4)
    np.testing.assert_array_equal(beam4.numpy(), np.asarray(jt))
    np.testing.assert_allclose(s4.numpy(), np.asarray(js_), **TOL)


def test_seq2seq_beam_lazy_matches_eager(jx, tiny):
    """Lazy beam decoding (ancestry tables) is token- and score-exact
    against the eager reorder, and both are JAX's; the cross caches are
    replicated once and never gathered again (their storage does not move
    across the steps)."""
    jm, params, model, src, _ = tiny
    s = _port(src).long()
    lazy_t, lazy_s = seq2seq_generate_beam(model, s, bos_id=1, max_new_tokens=7, num_beams=4)
    eager_t, eager_s = seq2seq_generate_beam(model, s, bos_id=1, max_new_tokens=7, num_beams=4,
                                             lazy=False)
    assert torch.equal(lazy_t, eager_t)
    np.testing.assert_allclose(lazy_s.numpy(), eager_s.numpy(), rtol=1e-5, atol=1e-5)
    jt, _ = jx.s2s.seq2seq_generate_beam(jm, params, jx.jnp.asarray(src), bos_id=1,
                                         max_new_tokens=7, num_beams=4, lazy=False)
    np.testing.assert_array_equal(lazy_t.numpy(), np.asarray(jt))


def test_cross_cache_written_once(tiny):
    """The memory is projected at the prefill only: a decode step reads the
    head-major cross cache in place, and neither beam form gathers it per
    step (its storage is the same object after every step)."""
    from tpu_parallel_torch.models import seq2seq as s2s

    _, _, model, src, _ = tiny
    s = _port(src).long()
    calls = []
    kv = model.decoder.layer_0.cross_attn.kv
    handle = kv.register_forward_hook(lambda *a: calls.append(1))
    try:
        seq2seq_generate(model, s, max_new_tokens=5)
    finally:
        handle.remove()
    assert len(calls) == 1
    seen = {}
    real = s2s.cross_decode_attention

    def spy(q, k_heads, v_heads, mask):
        seen.setdefault(q.shape[0], set()).add((k_heads.data_ptr(), v_heads.data_ptr()))
        assert k_heads.is_contiguous() and k_heads.shape[1] == q.shape[0]
        return real(q, k_heads, v_heads, mask)

    s2s.cross_decode_attention = spy
    try:
        for lazy in (True, False):
            seen.clear()
            seq2seq_generate_beam(model, s, max_new_tokens=5, num_beams=3, lazy=lazy)
            # the prefill's rows (2) and the beams' (6): one storage each
            # per layer, whatever the number of steps
            assert sorted(seen) == [2, 6] and len(seen[6]) == model.config.n_layers, seen
    finally:
        s2s.cross_decode_attention = real


def test_seq2seq_batch_copy_task(jx):
    """``seq2seq_batch`` is JAX's copy task: the source in [2, vocab), the
    target the source cycled to the target length, BOS then the target
    shifted, an all-True mask (shapes and structure; the draws are the
    port's own)."""
    from tpu_parallel.data import seq2seq_batch as jax_seq2seq_batch
    from tpu_parallel_torch.data import seq2seq_batch

    for src_len, dst_len in ((8, 20), (16, 8)):
        b = seq2seq_batch(torch.Generator().manual_seed(0), 3, src_len, dst_len, 50)
        want = jax_seq2seq_batch(jx.jax.random.PRNGKey(0), 3, src_len, dst_len, 50)
        for name in ("src_tokens", "tokens", "targets", "src_mask"):
            assert tuple(getattr(b, name).shape) == tuple(getattr(want, name).shape), name
        assert b.src_tokens.min() >= 2 and b.src_tokens.max() < 50 and bool(b.src_mask.all())
        cycled = b.src_tokens.repeat(1, -(-dst_len // src_len))[:, :dst_len]
        assert torch.equal(b.targets, cycled)
        assert torch.equal(b.tokens[:, 1:], b.targets[:, :-1]) and bool((b.tokens[:, 0] == 1).all())


def test_trainer_seq2seq_rejects_single_stack_objective(jx):
    """``tests/test_train_lib.py:194``: an MLM objective on an
    encoder-decoder is refused, in JAX's words."""
    from tpu_parallel.runtime import MeshConfig as JMeshConfig
    from tpu_parallel.train_lib import Trainer as JTrainer
    from tpu_parallel.train_lib import TrainerConfig as JTrainerConfig
    from tpu_parallel_torch.train_lib import Trainer, TrainerConfig

    with pytest.raises(ValueError, match="single-stack") as want:
        JTrainer(JTrainerConfig(model="tiny_seq2seq", mesh=JMeshConfig(data=8), objective="mlm"))
    with pytest.raises(ValueError, match="single-stack") as got:
        Trainer(TrainerConfig(model="tiny_seq2seq", mesh=dict(data=1), objective="mlm"),
                device="cpu")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="Seq2SeqBatch"):
        Trainer(TrainerConfig(model="tiny_seq2seq", mesh=dict(data=1), steps=1),
                device="cpu").train(batch_iter=iter([object()]))


def test_seq2seq_flash_matches_xla(jx):
    """``t5_small``'s attention path at toy size: the encoder's flash call
    (non-causal over padding segments) and the decoder's (causal), through
    the kernels' plain versions here, against the xla path and JAX's xla
    path: logits and the loss's gradients."""
    jm, params, xla = _bridged(jx, seed=5, norm="rmsnorm", seq_len=64, src_seq_len=64)
    flash = EncoderDecoder(dataclasses.replace(xla.config, attn_impl="flash", flash_block_q=32,
                                               flash_block_k=32), device="cpu", seed=None)
    flash.load_state_dict(xla.state_dict())
    b = _copy_batch(2, 64, seed=6)
    b["src_mask"][0, 40:] = False
    b["src_mask"][1, 57:] = False
    want = _japply(jx, jm, params, b["src_tokens"], b["tokens"], b["src_mask"])
    for model in (xla, flash):
        np.testing.assert_allclose(_logits(model, b["src_tokens"], b["tokens"], b["src_mask"]),
                                   want, **TOL)
    jax = jx.jax
    jgrads = jax.jit(jax.grad(lambda p: jx.s2s.make_seq2seq_loss(jm.config)(
        p, jm.apply, _jax_batch(jx, b), jax.random.PRNGKey(0))[0]))(params)
    for model in (xla, flash):
        loss, _ = make_seq2seq_loss(model.config)(model, _port_batch(b))
        _assert_grads(_grads(model, loss), jgrads, model.config)


# -- the relative position bias ----------------------------------------------


def test_relative_bucket_table_matches_jax(jx):
    """``t5_relative_bucket`` and the host table the bias indexes equal
    JAX's buckets exactly, for every relative position in [-2 seq, 2 seq],
    both directions, at T5's 32 buckets / 128 and at toy values."""
    # jitted, as the JAX model computes it
    bucket = jx.jax.jit(jx.layers.t5_relative_bucket, static_argnums=(1, 2, 3))
    for bidirectional in (True, False):
        for nb, md, seq in ((32, 128, 512), (32, 128, 32), (8, 16, 32), (16, 20, 64)):
            rel = np.arange(-2 * seq, 2 * seq + 1, dtype=np.int32)
            want = np.asarray(bucket(jx.jnp.asarray(rel), bidirectional, nb, md))
            got = layers.t5_relative_bucket(_port(rel), bidirectional, nb, md).numpy()
            table = layers._bucket_table(bidirectional, nb, md)
            looked_up = table[_port(rel).long().clamp(-md, md) + md].numpy()
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(looked_up, want)


@pytest.mark.parametrize("variant", ["causal", "bidirectional"])
def test_relative_gptlm_matches_jax(jx, variant):
    """``tiny_test(positional="relative")``: one ``rel_bias`` table above the
    stack; the forward, the LM loss and its gradients are JAX's, and
    (causal) greedy ``generate()`` is JAX's token for token."""
    from tpu_parallel.core.state import TextBatch as JTextBatch
    from tpu_parallel.models.generate import generate as jax_generate
    from tpu_parallel_torch.core.state import TextBatch
    from tpu_parallel_torch.models.generate import generate
    from tpu_parallel_torch.models.gpt import make_gpt_loss

    jax, jnp = jx.jax, jx.jnp
    over = dict(positional="relative", scan_layers=False, bidirectional=variant != "causal",
                n_layers=2)
    model = GPTLM(tiny_test(**over), device="cpu", seed=7)
    params = _to_jax(jx, model)
    assert "rel_bias" in params and "pos" not in params["embed"]
    jm = jx.gpt.GPTLM(jx.gpt.tiny_test(dtype=jnp.float32, remat=False, **over))
    tokens = _tokens((2, 24), 8)
    with torch.no_grad():
        got = model(_port(tokens).long()).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply({"params": params}, tokens, train=False)),
                               **TOL)
    targets = np.roll(tokens, -1, axis=1)
    jloss_fn = jx.gpt.make_gpt_loss(jm.config)
    jb = JTextBatch(tokens=jnp.asarray(tokens), targets=jnp.asarray(targets))
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jloss_fn(p, jm.apply, jb, jax.random.PRNGKey(0))[0]))(params)
    loss, _ = make_gpt_loss(model.config)(model, TextBatch(tokens=_port(tokens).long(),
                                                           targets=_port(targets).long()))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want = params_from_jax(_np(jgrads), model.config, dtype=torch.float32)
    got_g = _grads(model, loss)
    for key, value in want.items():
        np.testing.assert_allclose(got_g[key].numpy(), value.numpy(), **GRAD_TOL, err_msg=key)
    if variant == "causal":
        toks = generate(model, _port(tokens[:, :8]).long(), max_new_tokens=10).numpy()
        np.testing.assert_array_equal(
            toks, np.asarray(jax_generate(jm, params, jnp.asarray(tokens[:, :8]),
                                          max_new_tokens=10)))


@pytest.mark.parametrize("mlp", ["relu", "geglu"])
def test_relative_seq2seq_matches_jax(jx, mlp):
    """The T5-shaped variant (relative bias per stack, RMSNorm, bias-free,
    relu or geglu): logits over a padded source and the loss's gradients,
    and (relu) greedy and beam tokens, all JAX's."""
    jm, params, model = _bridged(jx, seed=9, **dict(T5ISH, mlp=mlp, n_layers=1, enc_layers=1))
    assert set(params["enc_rel_bias"]) == {"rel_embedding"} and "pos" not in params["embed"]
    b = _copy_batch(2, 16, seed=10)
    b["src_mask"][1, 11:] = False
    np.testing.assert_allclose(
        _logits(model, b["src_tokens"], b["tokens"], b["src_mask"]),
        _japply(jx, jm, params, b["src_tokens"], b["tokens"], b["src_mask"]), **TOL)
    jax = jx.jax
    jgrads = jax.jit(jax.grad(lambda p: jx.s2s.make_seq2seq_loss(jm.config)(
        p, jm.apply, _jax_batch(jx, b), jax.random.PRNGKey(0))[0]))(params)
    loss, _ = make_seq2seq_loss(model.config)(model, _port_batch(b))
    _assert_grads(_grads(model, loss), jgrads, model.config)
    if mlp != "relu":
        return  # decoding is the MLP's business no more than the forward's
    src, mask = jx.jnp.asarray(b["src_tokens"]), jx.jnp.asarray(b["src_mask"])
    toks = seq2seq_generate(model, _port(b["src_tokens"]).long(), _port(b["src_mask"]),
                            max_new_tokens=8, bos_id=1)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jx.s2s.seq2seq_generate(
        jm, params, src, mask, max_new_tokens=8, bos_id=1)))
    for lazy in (True, False):
        bt, bs = seq2seq_generate_beam(model, _port(b["src_tokens"]).long(),
                                       _port(b["src_mask"]), bos_id=1, max_new_tokens=6,
                                       num_beams=3, lazy=lazy)
        jt, js_ = jx.s2s.seq2seq_generate_beam(jm, params, src, mask, bos_id=1,
                                               max_new_tokens=6, num_beams=3, lazy=lazy)
        np.testing.assert_array_equal(bt.numpy(), np.asarray(jt))
        np.testing.assert_allclose(bs.numpy(), np.asarray(js_), **TOL)


def test_relative_refusals(jx):
    """The relative bias's refusals on ``GPTLM``, the generator and the
    engine, in JAX's words: a kernel path (flash, ring, Ulysses), a
    pipeline, packed segments, slot-indexed writes, ragged prompts, the
    serving engine (``tests/test_serving.py:582``)."""
    from tpu_parallel import serving as jserving
    from tpu_parallel.models.generate import generate as jax_generate
    from tpu_parallel_torch import serving
    from tpu_parallel_torch.models.generate import generate

    jax, jnp = jx.jax, jx.jnp
    rel = dict(positional="relative")
    toks = jnp.zeros((2, 8), jnp.int32)

    def jax_error(over, **kw):
        jm = jx.gpt.GPTLM(jx.gpt.tiny_test(dtype=jnp.float32, **dict(rel, **over)))
        with pytest.raises(NotImplementedError) as exc:
            jm.init(jax.random.PRNGKey(0), toks, train=False, **kw)
        return str(exc.value)

    for over in (dict(attn_impl="flash"), dict(attn_impl="ring"), dict(attn_impl="ulysses"),
                 dict(pipe_size=2)):
        with pytest.raises(NotImplementedError) as got:
            GPTLM(tiny_test(**dict(rel, **over)), device="cpu")
        assert str(got.value) == jax_error(over), over
    model = GPTLM(tiny_test(**rel), device="cpu", seed=0)
    with pytest.raises(NotImplementedError) as got:
        model(torch.zeros(2, 8, dtype=torch.long), segment_ids=torch.zeros(2, 8, dtype=torch.int))
    assert str(got.value) == jax_error({}, segment_ids=jnp.zeros((2, 8), jnp.int32))
    with pytest.raises(NotImplementedError) as got:
        model(torch.zeros(2, 1, dtype=torch.long), decode=True, cache=model.init_cache(2),
              write_index=torch.zeros(2, dtype=torch.long))
    assert str(got.value) == jax_error({}, decode=True, write_index=jnp.zeros(2, jnp.int32))
    jm = jx.gpt.GPTLM(jx.gpt.tiny_test(dtype=jnp.float32, **rel))
    params = _to_jax(jx, model)
    mask = np.ones((2, 8), bool)
    mask[0, :3] = False
    with pytest.raises(NotImplementedError) as want:
        jax_generate(jm, params, toks, max_new_tokens=2, prompt_mask=jnp.asarray(mask))
    with pytest.raises(NotImplementedError) as got:
        generate(model, torch.zeros(2, 8, dtype=torch.long), max_new_tokens=2,
                 prompt_mask=_port(mask))
    assert str(got.value) == str(want.value)
    with pytest.raises(NotImplementedError, match="relative") as want:
        jserving.ServingEngine(jm, params, n_slots=2)
    with pytest.raises(NotImplementedError, match="relative") as got:
        serving.ServingEngine(model, n_slots=2)
    assert str(got.value) == str(want.value)


# -- the 8-rank group ---------------------------------------------------------


def _case_reference(name):
    """The one-device config overrides and batch shape a training case is
    held to (cases that share them share JAX's gradients)."""
    overrides, _, rows = S2S_TRAIN[name]
    ref = {k: v for k, v in overrides.items()
           if k not in ("attn_impl", "fsdp", "fsdp_min_size", "num_microbatches")}
    return ref, rows, 64 if "seq_len" in overrides else 16


def _case_weights(jx, name):
    """(JAX model, params as JAX's tree, the case's batch) of a training
    case: the port's seeded init of its one-device config as JAX's tree."""
    ref, rows, length = _case_reference(name)
    jm, params, _ = _bridged(jx, seed=11, **ref)
    return jm, params, _copy_batch(rows, length, seed=12)


def _jax_case(jx, name):
    """(loss, gradients): JAX's one-device loss of the case's batch and the
    gradients of the objective its synced gradients make: the batch's mean
    loss, or under MoE the mean over the data shards of each shard's loss
    (capacity is per shard; one compiled shard function, called per
    shard)."""
    ref, rows, length = _case_reference(name)
    key = ("case", tuple(sorted(ref.items())), rows, length)
    if key not in jx.cache:
        jax = jx.jax
        jm, params, b = _case_weights(jx, name)
        loss_fn = jx.s2s.make_seq2seq_loss(jm.config)
        value_and_grad = jax.jit(jax.value_and_grad(
            lambda p, part: loss_fn(p, jm.apply, _jax_batch(jx, part), jax.random.PRNGKey(0))[0]))
        shards = S2S_TRAIN[name][1]["data"] if "moe_experts" in ref else 1
        n = rows // shards
        parts = [value_and_grad(params, {k: v[i * n:(i + 1) * n] for k, v in b.items()})
                 for i in range(shards)]
        grads = jax.tree.map(lambda *g: sum(g) / shards, *[g for _, g in parts])
        jx.cache[key] = (float(sum(v for v, _ in parts) / shards), grads)
    return jx.cache[key]


def _rel_gptlm(jx):
    model = GPTLM(tiny_test(positional="relative", norm="rmsnorm", dense_bias=False,
                            scan_layers=False), device="cpu", seed=13)
    return model, _to_jax(jx, model)


@pytest.fixture(scope="module")
def ranks(jx, tmp_path_factory):
    def make_inputs(outdir):
        inputs = {}
        for name in S2S_TRAIN:
            _, params, b = _case_weights(jx, name)
            inputs.update(flat_tree(f"{name}_params", _np(params)))
            inputs.update(flat_tree(f"{name}_batch", b))
        inputs["gen_src"] = _tokens((S2S_GEN["rows"], 16), 14, low=2)
        inputs.update(flat_tree("rel_params", _np(_rel_gptlm(jx)[1])))
        inputs["rel_prompt"] = _tokens((8, 4), 15)
        return inputs

    return run_once("seq2seq", tmp_path_factory, make_inputs, num_ranks=NUM_RANKS)


def _merged(ranks, prefix):
    out = {}
    for rank in ranks:
        for key, value in rank.items():
            if key.startswith(prefix + "/"):
                out.setdefault(key[len(prefix) + 1:], value)
    return out


def _train_case(jx, ranks, name):
    """Every rank's synced gradients (a pipe rank its stage's, split leaves
    assembled) against JAX's; falling losses, equal on every rank."""
    overrides = S2S_TRAIN[name][0]
    cfg = tiny_seq2seq(**{k: v for k, v in overrides.items() if k != "num_microbatches"})
    want = params_from_jax(_np(_jax_case(jx, name)[1]), cfg, dtype=torch.float32)
    got = _merged(ranks, f"{name}_grads")
    assert sorted(got) == sorted(want)
    for key, value in got.items():
        np.testing.assert_allclose(value, want[key].numpy(), **GRAD_TOL, err_msg=key)
    for out in ranks:
        losses = out[f"{name}_losses"]
        assert len(losses) == S2S_STEPS and np.all(np.isfinite(losses)), losses
        assert losses[-1] < losses[0], losses
        np.testing.assert_array_equal(losses, ranks[0][f"{name}_losses"])


def _specs(ranks, name):
    return dict(s.split("=", 1) for s in ranks[0][f"{name}_specs"])


def test_seq2seq_dp_training(jx, ranks):
    """``:160``: data=8."""
    _train_case(jx, ranks, "dp")


@pytest.mark.parametrize("name", ["tp", "tp_relative"])
def test_seq2seq_tp_training(jx, ranks, name):
    """``:166``: data 4 x model 2, the CE vocab-parallel; the attention
    projections (self and cross) are model-sharded; with the relative bias
    each rank takes its local heads' slice of it."""
    _train_case(jx, ranks, name)
    specs = _specs(ranks, name)
    for key in ("encoder.layer_0.attn.qkv.weight", "decoder.layer_0.cross_attn.kv.weight",
                "decoder.layer_0.cross_attn.q.weight", "lm_head.weight"):
        assert "model" in specs[key], (key, specs[key])


def test_seq2seq_fsdp_training(jx, ranks):
    """``:178``: FSDP shards the encoder, the decoder (cross-attention's
    weights too) and the lm_head over data."""
    _train_case(jx, ranks, "fsdp")
    specs = _specs(ranks, "fsdp")
    for sub in ("encoder.", "cross_attn", "lm_head"):
        hits = [v for k, v in specs.items() if sub in k and k.endswith("weight")
                and "norm" not in k]
        assert hits and all("data" in v for v in hits), (sub, hits)


def test_seq2seq_vocab_parallel_ce_matches_full(ranks):
    """``:195``: the TP loss path's vocab-parallel CE equals the plain CE of
    the gathered logits on the same state and tokens."""
    for out in ranks:
        vp, full = out["tp_ce"]
        np.testing.assert_allclose(vp, full, rtol=1e-5)


def test_sharded_generate_matches_exported(jx, ranks):
    """``:252``: sharded decoding of the trained state over data=8 equals
    plain decoding of ``export_single_device_params``' weights, and JAX's
    tokens on those weights."""
    cfg = tiny_seq2seq(scan_layers=False)
    for out in ranks:
        np.testing.assert_array_equal(out["exported_sharded"], ranks[0]["exported_plain"])
    sd = {k: torch.from_numpy(v) for k, v in _merged(ranks, "exported").items()}
    params = jx.jax.tree.map(lambda t: jx.jnp.asarray(t.numpy()), params_to_jax(sd, cfg))
    jm = jx.s2s.EncoderDecoder(jx.s2s.tiny_seq2seq(scan_layers=False, remat=False))
    want = jx.s2s.seq2seq_generate(jm, params, jx.jnp.asarray(_gen_src()),
                                   max_new_tokens=S2S_GEN["new"], bos_id=S2S_GEN["bos"])
    np.testing.assert_array_equal(ranks[0]["exported_plain"], np.asarray(want))


def _gen_src():
    return _tokens((S2S_GEN["rows"], 16), 14, low=2)


def test_sharded_generate_tp_mesh(jx, ranks):
    """``:275``: TP-split weights serve without export; the greedy tokens
    equal the teacher-forced argmax of the same TP state's forward, equal
    on every rank, and JAX's tokens on the assembled weights."""
    for out in ranks:
        np.testing.assert_array_equal(out["tp_gen"], out["tp_gen_forced"])
        np.testing.assert_array_equal(out["tp_gen"], ranks[0]["tp_gen"])
    sd = {k: torch.from_numpy(v) for k, v in _merged(ranks, "tp_final").items()}
    cfg = tiny_seq2seq(scan_layers=False)
    params = jx.jax.tree.map(lambda t: jx.jnp.asarray(t.numpy()), params_to_jax(sd, cfg))
    jm = jx.s2s.EncoderDecoder(jx.s2s.tiny_seq2seq(scan_layers=False, remat=False))
    want = jx.s2s.seq2seq_generate(jm, params, jx.jnp.asarray(_gen_src()[:4]),
                                   max_new_tokens=S2S_GEN["new"], bos_id=S2S_GEN["bos"])
    np.testing.assert_array_equal(ranks[0]["tp_gen"], np.asarray(want))


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_seq2seq_sp_training(jx, ranks, impl):
    """``:322``: both stacks shard their token axes over data 2 x seq 4, the
    decoder gathering the memory: synced gradients JAX's, falling losses."""
    _train_case(jx, ranks, impl)


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_seq2seq_sp_matches_dense(jx, ranks, impl):
    """``:359``: the SP model's global-mean loss over the seq-sharded batch
    equals the dense model's over whole rows on one set of weights, and
    JAX's loss there."""
    jloss = _jax_case(jx, impl)[0]
    for out in ranks:
        sp, dense = out[f"{impl}_sp_vs_dense"]
        np.testing.assert_allclose(sp, dense, rtol=1e-5)
        np.testing.assert_allclose(sp, float(jloss), rtol=1e-5)


def test_seq2seq_moe_training(jx, ranks):
    """``:422``: routed experts in both stacks, expert-parallel over the
    model axis of data 4 x model 2: synced gradients JAX's (the mean of
    the data shards' objectives), a positive balance, falling losses."""
    _train_case(jx, ranks, "moe")
    assert all(float(out["moe_balance"]) > 0 for out in ranks)


def test_seq2seq_pp_training(jx, ranks):
    """``:451``: data 2 x pipe 4, each pipe rank owning one encoder and one
    decoder block, two GPipe passes, the memory's gradient through the
    decoder pipeline's extras: every rank's stage gradients JAX's."""
    _train_case(jx, ranks, "pp")
    for out in ranks:
        r = int(out["pp_coord"])
        stage = {k for k in out if k.startswith("pp_grads/") and ".layer_" in k}
        assert stage and all(f".layer_{r}." in k for k in stage), stage


def test_trainer_seq2seq_family(ranks):
    """``tests/test_train_lib.py:168``: the Trainer on ``tiny_seq2seq`` over
    data 4 x model 2 trains and evaluates below its first loss."""
    for out in ranks:
        first, last, ev, has_rate = out["trainer_family"]
        assert last < first and ev < first and has_rate


def test_mesh_bound_refusals_are_loud(jx, ranks, mesh_pipe4_data2):
    """``:528``: the relative bias under a pipeline and decoding on a pipe
    mesh raise JAX's errors, in its words."""
    from jax.sharding import PartitionSpec as P

    jax, jnp = jx.jax, jx.jnp
    src = jnp.zeros((8, 8), jnp.int32)
    rel = jx.s2s.EncoderDecoder(jx.s2s.tiny_seq2seq(pipe_size=4, enc_layers=4, n_layers=4,
                                                    positional="relative", norm="rmsnorm"))
    with pytest.raises(NotImplementedError) as want:
        jax.eval_shape(jax.shard_map(
            lambda s, d: rel.init({"params": jax.random.PRNGKey(0)}, s, d, train=False),
            mesh=mesh_pipe4_data2, in_specs=(P("data"), P("data")), out_specs=P(),
            check_vma=False), src, src)
    pp_model = jx.s2s.EncoderDecoder(jx.s2s.tiny_seq2seq(pipe_size=4, enc_layers=4, n_layers=4))

    def try_decode(s, d):
        v = pp_model.init({"params": jax.random.PRNGKey(0)}, s, d, train=False)
        return pp_model.apply(v, s, d, train=False, decode=True, mutable=["cache"])

    with pytest.raises(NotImplementedError, match="decoding") as want_decode:
        jax.eval_shape(jax.shard_map(try_decode, mesh=mesh_pipe4_data2,
                                     in_specs=(P("data"), P("data")), out_specs=P(),
                                     check_vma=False), src, src)
    for out in ranks:
        assert str(out["refuse_rel_pp"]) == str(want.value)
        assert str(out["refuse_pp_decode"]) == str(want_decode.value)


def test_sp_decode_refusal(jx, ranks):
    """``:579``: decoding with a bound seq axis refuses, in JAX's words."""
    for out in ranks:
        assert str(out["refuse_sp_decode"]) == (
            "incremental decoding under sequence parallelism "
            "(serve seq2seq on a data/model mesh)")


def test_relative_bias_sharded_generate_aligned(jx, ranks):
    """``tests/test_generate.py:711``: a relative-bias GPTLM decodes on the
    sharded path without a mask over data=8: the tokens equal one
    process's and JAX's on the same weights."""
    model, params = _rel_gptlm(jx)
    from tpu_parallel.models.generate import generate as jax_generate

    jm = jx.gpt.GPTLM(jx.gpt.tiny_test(dtype=jx.jnp.float32, positional="relative",
                                       norm="rmsnorm", dense_bias=False, scan_layers=False))
    want = np.asarray(jax_generate(jm, params, jx.jnp.asarray(_tokens((8, 4), 15)),
                                   max_new_tokens=4))
    for out in ranks:
        assert out["rel_sharded"].shape == (8, 4)
        np.testing.assert_array_equal(out["rel_sharded"], out["rel_single"])
        np.testing.assert_array_equal(out["rel_sharded"], want)


@pytest.mark.gpu
def test_seq2seq_flash_on_the_card_matches_xla():
    """On the card: a bf16 encoder-decoder's flash path (the CUDA kernels:
    non-causal over padding segments in the encoder, causal in the
    decoder) against its xla path; a backward pass launches each kernel
    once per layer of each stack."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from tpu_parallel_torch.ops import flash_attention as fa

    cfg = tiny_seq2seq(seq_len=128, src_seq_len=128, d_model=256, n_heads=4,
                       dtype=torch.bfloat16, attn_impl="flash", remat=False)
    flash = EncoderDecoder(cfg, device="cuda", seed=0)
    xla = EncoderDecoder(dataclasses.replace(cfg, attn_impl="xla"), device="cuda", seed=0)
    gen = torch.Generator().manual_seed(1)
    src = torch.randint(2, 256, (4, 128), generator=gen).cuda()
    dst = torch.randint(2, 256, (4, 128), generator=gen).cuda()
    mask = (torch.arange(128)[None] < torch.tensor([[128], [90], [64], [100]])).cuda()
    before = (fa.flash_fwd_launches, fa.flash_bwd_launches)
    out = flash(src, dst, mask)
    out.float().square().mean().backward()
    layers_ = cfg.encoder_layers + cfg.n_layers
    assert (fa.flash_fwd_launches - before[0], fa.flash_bwd_launches - before[1]) == (
        layers_, layers_)
    with torch.no_grad():
        want = xla(src, dst, mask).float()
    assert (out.detach().float() - want).abs().max().item() < 0.1


def test_bridge_mesh_layouts_round_trip(jx, mesh_data4_model2, mesh_pipe4_data2):
    """The bridge reads JAX's mesh-initialized ``EncoderDecoder`` trees: the
    TP layout (every split leaf stacked ``[tp, ...]`` under
    ``shard/sharded``) per model rank, and the pipe layout (both stacks
    under ``encoder/stage/sharded`` and ``decoder/stage/sharded``, scanned
    inside) per pipe rank; ``params_to_jax`` of every rank's state dicts
    gives JAX's tree back bitwise; a missing leaf, an extra leaf and a
    wrong shape still raise."""
    import flax.linen as nn
    from jax.sharding import PartitionSpec as P

    jax, jnp = jx.jax, jx.jnp
    src = jnp.zeros((8, 16), jnp.int32)

    def mesh_tree(cfg, mesh):
        model = jx.s2s.EncoderDecoder(cfg)

        def init(s, d):
            return model.init({"params": jax.random.PRNGKey(0)}, s, d, train=False)["params"]

        probe = jax.shard_map(init, mesh=mesh, in_specs=(P("data"), P("data")), out_specs=P(),
                              check_vma=False)
        specs = nn.get_partition_spec(jax.eval_shape(probe, src, src))
        tree = jax.jit(jax.shard_map(init, mesh=mesh, in_specs=(P("data"), P("data")),
                                     out_specs=specs, check_vma=False))(src, src)
        return jax.tree.map(np.asarray, nn.unbox(tree))

    def assert_trees(got, want, path=""):
        assert sorted(got) == sorted(want), path
        for k, v in want.items():
            if isinstance(v, dict):
                assert_trees(got[k], v, f"{path}/{k}")
            else:
                np.testing.assert_array_equal(np.asarray(got[k]), v, err_msg=f"{path}/{k}")

    tp_cfg = tiny_seq2seq(scan_layers=False)
    tp_tree = mesh_tree(jx.s2s.tiny_seq2seq(scan_layers=False), mesh_data4_model2)
    assert "sharded" in tp_tree["decoder"]["layer_0"]["cross_attn"]["kv"]["shard"]
    ranks = [params_from_jax(tp_tree, tp_cfg, dtype=torch.float32, model_rank=r) for r in (0, 1)]
    assert ranks[0]["decoder.layer_0.cross_attn.kv.weight"].shape == (32, 32)
    assert_trees(params_to_jax(ranks, tp_cfg, _mesh_layout=True), tp_tree)
    full = params_from_jax(tp_tree, tp_cfg, dtype=torch.float32)
    assert full["decoder.layer_0.cross_attn.kv.weight"].shape == (64, 32)

    pp_over = dict(pipe_size=4, enc_layers=4, n_layers=4, num_microbatches=4)
    pp_cfg = tiny_seq2seq(**pp_over)
    pp_tree = mesh_tree(jx.s2s.tiny_seq2seq(**pp_over), mesh_pipe4_data2)
    assert "stage" in pp_tree["encoder"] and "stage" in pp_tree["decoder"]
    stages = [params_from_jax(pp_tree, pp_cfg, dtype=torch.float32, pipe_rank=r, model_rank=0)
              for r in range(4)]
    assert sorted(k for k in stages[2] if k.startswith("decoder.")) == sorted(
        k for k in stages[2] if k.startswith("decoder.layer_2."))
    assert_trees(params_to_jax(stages, pp_cfg), pp_tree)

    flat = {k: v for k, v in tp_tree.items()}
    with pytest.raises(KeyError, match="lacks"):
        params_from_jax({k: v for k, v in flat.items() if k != "dec_norm"}, tp_cfg)
    with pytest.raises(ValueError, match="leaves the port does not"):
        params_from_jax(dict(flat, extra={"kernel": np.zeros(3)}), tp_cfg)
    bad = jax.tree.map(lambda x: x, tp_tree)
    bad["enc_norm"]["scale"] = np.zeros(7, np.float32)
    with pytest.raises(ValueError, match="does not fit"):
        params_from_jax(bad, tp_cfg)
