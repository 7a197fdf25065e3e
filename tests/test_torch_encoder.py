"""Port parity: the bidirectional encoder family (post-norm blocks, the
embedding LayerNorm, non-causal flash through ``flash_chunk_attention``,
``EncoderClassifier``, ``make_mlm_loss``) against the JAX package.

Mirrors ``tests/test_encoder.py`` case for case on bridged ``tiny_test``
weights (fp32, CPU; JAX on its xla path or its flash kernels in interpret
mode, the port's flash path on the kernels' plain versions):
full visibility, flash against xla with GQA, packing, padding and a
window (forward and gradients), the symmetric window, the classifier's
pooling and refusal, and the decode refusal on every decode path
(``generate()``, the engine's ticks, ``verify_step``, beam search).  The
MLM loss is held to JAX's on JAX's own mask (the port's random bits are
not JAX's).  The mesh cases run once, in one 8-rank gloo group
(``tests/torch_dp_worker.py``, suite ``encoder``): MLM over data=8, data 4
x model 2 (vocab-parallel CE), data 2 x model 2 x pipe 2 (post-norm: the
first stage's embedding norm, no final norm), ring, Ulysses and a windowed
ring over data 2 x seq 4, the post-norm variant over data=8, and the
classifier over data=8: each rank's synced step-1 gradients on JAX's mask
against JAX's one-device gradients of the same objective (each data and
seq shard's token mean, averaged over the shards), then falling losses on
the port's own masks; the mask's fold over data and seq only; the
bidirectional ring and Ulysses ops against dense attention.

Tolerances (fp32): outputs and logits 1e-5 (rtol and atol); gradients
rtol 1e-4, atol 1e-6; losses rtol 1e-5; tokens exactly.  JAX is imported
inside the fixtures, so the ``gpu`` case runs on the card with
``--noconftest``.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch
from torch_dp_worker import (ENCODER_CLASSES, ENCODER_CLS_STEPS, ENCODER_MLM, POSTNORM,
                             flat_tree, run_once)

from tpu_parallel_torch.models import GPTLM, layers, tiny_test
from tpu_parallel_torch.models.convert import params_from_jax, params_to_jax
from tpu_parallel_torch.models.gpt import EncoderClassifier, make_mlm_loss, mlm_mask

torch.set_num_threads(1)

NUM_RANKS = 8
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
MASK_RATE = 0.3


@pytest.fixture(scope="module")
def jx():
    """The JAX package's side."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from tpu_parallel.core.losses import token_cross_entropy
    from tpu_parallel.models import gpt as jgpt
    from tpu_parallel.models import layers as jlayers

    return types.SimpleNamespace(jax=jax, jnp=jnp, gpt=jgpt, layers=jlayers,
                                 ce=token_cross_entropy, cache={})


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree)


def _jax_model(jx, **overrides):
    return jx.gpt.GPTLM(jx.gpt.tiny_test(dtype=jx.jnp.float32, remat=False,
                                         **{"scan_layers": False, **overrides}))


def _to_jax(jx, module):
    """A port module's weights as the JAX package's (unrolled) tree, through
    ``params_to_jax``: the port's seeded init stands in for flax's."""
    return jx.jax.tree.map(lambda t: jx.jnp.asarray(t.float().numpy()),
                           params_to_jax(module.state_dict(), module.config))


def _bridged(jx, overrides, seed=0):
    """The port's model of ``overrides`` (fp32, unrolled) seeded with
    ``seed``, JAX's model of the same config and its weights as JAX's
    tree."""
    overrides = {"scan_layers": False, **overrides}
    model = GPTLM(tiny_test(**overrides), device="cpu", seed=seed)
    return _jax_model(jx, **overrides), _to_jax(jx, model), model.eval()


def _japply(jx, jm):
    """JAX's forward of ``jm`` (eval), jitted: ``(params, tokens, segment
    ids or None) -> logits``."""
    return jx.jax.jit(lambda p, t, seg: jm.apply({"params": p}, t, segment_ids=seg,
                                                 train=False))


def _tokens(rows, seq, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (rows, seq)).astype(np.int32)


def _packed(rows, seq, seed):
    cuts = np.sort(np.random.default_rng(seed).integers(1, seq - 1, (rows, 2)), axis=1)
    pos = np.arange(seq)[None]
    return ((pos >= cuts[:, :1]).astype(np.int32) + (pos >= cuts[:, 1:]).astype(np.int32))


def _padding(rows, seq, seed):
    """Real tokens (segment 0) then pads (segment 1), lengths from the seed."""
    lengths = np.random.default_rng(seed).integers(seq // 4, seq + 1, rows)
    return (np.arange(seq)[None] >= lengths[:, None]).astype(np.int32)


def _port(x):
    return torch.from_numpy(np.array(x))


def _logits(model, tokens, **kw):
    with torch.no_grad():
        return model(_port(tokens).long(), **{k: _port(v) for k, v in kw.items()}).numpy()


def _grads(model, loss):
    model.zero_grad()
    loss.backward()
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def _assert_grads(got, jax_grads, cfg):
    want = params_from_jax(_np(jax_grads), cfg, dtype=torch.float32)
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        np.testing.assert_allclose(got[key].numpy(), value.numpy(), **GRAD_TOL, err_msg=key)


# -- one device ---------------------------------------------------------------


def test_bidirectional_sees_future(jx):
    """A late token changes early outputs (no causal mask); the same
    weights under a causal config keep the prefix; both as JAX's."""
    overrides = dict(bidirectional=True, seq_len=32, scan_layers=False, n_layers=1)
    tokens = _tokens(1, 32)
    jm, params, model = _bridged(jx, overrides)
    tokens2 = tokens.copy()
    tokens2[0, -1] = (tokens2[0, -1] + 1) % 256
    base, pert = _logits(model, tokens), _logits(model, tokens2)
    apply = _japply(jx, jm)
    for got, t in ((base, tokens), (pert, tokens2)):
        np.testing.assert_allclose(got, np.asarray(apply(params, t, None)), **TOL)
    assert not np.allclose(base[:, 0], pert[:, 0])
    causal = GPTLM(tiny_test(seq_len=32, scan_layers=False, n_layers=1), device="cpu", seed=None)
    causal.load_state_dict(model.state_dict())
    cbase, cpert = _logits(causal, tokens), _logits(causal, tokens2)
    np.testing.assert_allclose(cbase[:, :-1], cpert[:, :-1], **TOL)
    jc = _jax_model(jx, seq_len=32, n_layers=1)
    np.testing.assert_allclose(cbase, np.asarray(_japply(jx, jc)(params, tokens, None)), **TOL)


FLASH_VARIANTS = {
    "mha": dict(n_kv_heads=None, seg=None, attn_window=0),
    "gqa_packed": dict(n_kv_heads=2, seg="packed", attn_window=0),
    "mha_padding": dict(n_kv_heads=None, seg="padding", attn_window=0),
    "gqa_padding_window": dict(n_kv_heads=2, seg="padding", attn_window=8),
}


@pytest.mark.parametrize("variant", sorted(FLASH_VARIANTS))
def test_bidirectional_flash_matches_xla(jx, variant):
    """The encoder's flash path (one non-causal chunk through the kernels'
    plain versions here) against its xla path and JAX's xla path: logits
    at 1e-5, and the gradients of a weighted mean of the logits, with GQA,
    packed or padding segments and a window."""
    spec = FLASH_VARIANTS[variant]
    overrides = dict(bidirectional=True, seq_len=64, scan_layers=False,
                     n_kv_heads=spec["n_kv_heads"], attn_window=spec["attn_window"])
    tokens = _tokens(2, 64, seed=1)
    seg = {None: None, "packed": _packed(2, 64, 7), "padding": _padding(2, 64, 7)}[spec["seg"]]
    jm, params, xla = _bridged(jx, overrides)
    flash = GPTLM(tiny_test(**overrides, attn_impl="flash", flash_block_q=32, flash_block_k=32),
                  device="cpu", seed=None)
    flash.load_state_dict(xla.state_dict())
    kw = {} if seg is None else dict(segment_ids=seg)
    want = np.asarray(_japply(jx, jm)(params, tokens, seg))
    np.testing.assert_allclose(_logits(xla, tokens, **kw), want, **TOL)
    np.testing.assert_allclose(_logits(flash, tokens, **kw), want, **TOL)
    weight = np.random.default_rng(3).standard_normal(want.shape).astype(np.float32)

    def objective(model):
        out = model(_port(tokens).long(), **{k: _port(v) for k, v in kw.items()})
        return (out * _port(weight)).mean()

    g_flash = _grads(flash, objective(flash))
    g_xla = _grads(xla, objective(xla))
    jg = jx.jax.jit(jx.jax.grad(lambda p: (jm.apply({"params": p}, tokens, segment_ids=seg,
                                                    train=False) * weight).mean()))(params)
    _assert_grads(g_flash, jg, flash.config)
    _assert_grads(g_xla, jg, xla.config)


@pytest.mark.parametrize("variant", ["prenorm", "postnorm"])
def test_mlm_loss_matches_jax_on_its_mask(jx, variant):
    """``make_mlm_loss`` on JAX's one-device mask (``bernoulli(fold_in(rng,
    17))``, what JAX's loss draws there): JAX's loss (rtol 1e-5), token
    count and gradients; a pad mask multiplies in."""
    overrides = dict(bidirectional=True, seq_len=32, **(POSTNORM if variant == "postnorm" else {}))
    tokens = _tokens(4, 32, seed=2)
    jm, params, model = _bridged(jx, overrides)
    jax, jnp = jx.jax, jx.jnp
    from tpu_parallel.core.state import TextBatch as JTextBatch
    from tpu_parallel_torch.core.state import TextBatch

    loss_mask = (_padding(4, 32, 5) == 0).astype(np.float32)
    rng = jax.random.PRNGKey(11)
    jbatch = JTextBatch(tokens=jnp.asarray(tokens), targets=jnp.asarray(tokens),
                        loss_mask=jnp.asarray(loss_mask))
    jloss_fn = jx.gpt.make_mlm_loss(jm.config, mask_rate=MASK_RATE)
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jloss_fn(p, jm.apply, jbatch, rng), has_aux=True))(params)
    masked = np.asarray(jax.random.bernoulli(jax.random.fold_in(rng, 17), MASK_RATE, tokens.shape))
    batch = TextBatch(tokens=_port(tokens).long(), targets=_port(tokens).long(),
                      loss_mask=_port(loss_mask))
    loss, metrics = make_mlm_loss(model.config, mask_rate=MASK_RATE)(
        model, batch, torch.Generator().manual_seed(0), masked=_port(masked))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert float(metrics["loss"][1]) == float(jmetrics["loss"][1]) == (masked * loss_mask).sum()
    _assert_grads(_grads(model, loss), jgrads, model.config)
    assert "norm_final.weight" not in dict(model.named_parameters()) or variant == "prenorm"


def test_mlm_mask_draw():
    """The port's own corruption pattern: about ``mask_rate`` of the
    positions, the same for the same generator state, new once the
    training loss has advanced the generator, while the evaluation variant
    leaves it where it was; the default [MASK] is the last vocabulary id."""
    from tpu_parallel_torch.core.state import TextBatch

    cfg = tiny_test(bidirectional=True, seq_len=64)
    tokens = torch.zeros(64, 64, dtype=torch.long)
    a = mlm_mask(cfg, tokens, torch.Generator().manual_seed(3), 0.15)
    b = mlm_mask(cfg, tokens, torch.Generator().manual_seed(3), 0.15)
    assert torch.equal(a, b) and abs(a.float().mean().item() - 0.15) < 0.02
    model = GPTLM(cfg, device="cpu", seed=0)
    batch = TextBatch(tokens=tokens[:2], targets=tokens[:2])
    seen = []

    class Spy(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.inner = model

        def forward(self, tokens, **kw):
            seen.append(tokens.clone())
            return self.inner(tokens, **kw)

    spy = Spy()
    spy.lm_head = model.lm_head
    rng = torch.Generator().manual_seed(9)
    state = rng.get_state()
    make_mlm_loss(cfg, train=False)(spy, batch, rng)
    assert torch.equal(rng.get_state(), state)
    make_mlm_loss(cfg)(spy, batch, rng)
    make_mlm_loss(cfg)(spy, batch, rng)
    assert torch.equal(seen[0], seen[1]) and not torch.equal(seen[1], seen[2])
    assert set(seen[0].unique().tolist()) <= {0, cfg.vocab_size - 1}


def test_encoder_refusals(jx):
    """Decoding a bidirectional model raises JAX's error, in its words, on
    every decode path: the model's decode call, ``generate()``,
    ``generate_beam`` (lazy and eager), ``verify_step`` and the engine's
    per-step and fused ticks."""
    from tpu_parallel_torch import serving
    from tpu_parallel_torch.models.generate import generate, generate_beam, verify_step

    tokens = np.zeros((1, 32), np.int32)
    jm, params, model = _bridged(jx, dict(bidirectional=True, seq_len=32))
    with pytest.raises(NotImplementedError, match="bidirectional") as want:
        jm.apply({"params": params}, jx.jnp.asarray(tokens), train=False, decode=True,
                 mutable=["cache"])
    prompt = torch.zeros(2, 4, dtype=torch.long)
    paths = {
        "decode": lambda: model(prompt, decode=True, cache=model.init_cache(2)),
        "generate": lambda: generate(model, prompt, max_new_tokens=2),
        "beam_lazy": lambda: generate_beam(model, prompt, max_new_tokens=2, num_beams=2),
        "beam_eager": lambda: generate_beam(model, prompt, max_new_tokens=2, num_beams=2,
                                            lazy=False),
        "verify_step": lambda: verify_step(model, model.init_cache(2), prompt,
                                           torch.arange(4).expand(2, 4),
                                           torch.zeros(2, dtype=torch.long)),
    }
    for ticks in (1, 4):
        def run(ticks=ticks):
            eng = serving.ServingEngine(model, n_slots=2, decode_steps_per_tick=ticks)
            eng.add_request(serving.Request(prompt=[1, 2, 3], max_new_tokens=3))
            eng.run()
        paths[f"engine_T{ticks}"] = run
    for name, call in paths.items():
        with pytest.raises(NotImplementedError, match="bidirectional") as got:
            with torch.no_grad():
                call()
        assert str(got.value) == str(want.value), name


def test_encoder_classifier_finetunes(jx):
    """The BERT fine-tune shape on one device: the classifier's logits
    (both pools) are JAX's on bridged weights, its step-1 gradients under
    the classification loss are JAX's, and 25 AdamW steps memorize a tiny
    labeled set (the data=8 mesh run is the group's)."""
    from tpu_parallel.core.losses import make_classification_loss as jmake
    from tpu_parallel.core.state import Batch as JBatch
    from tpu_parallel_torch.core.losses import make_classification_loss
    from tpu_parallel_torch.core.metrics import compute
    from tpu_parallel_torch.core.optim import AdamW
    from tpu_parallel_torch.core.state import Batch
    from tpu_parallel_torch.parallel.spmd import build_train_functions, make_model_init

    jax, jnp = jx.jax, jx.jnp
    cfg_j = jx.gpt.tiny_test(bidirectional=True, seq_len=16, dtype=jnp.float32, remat=False,
                             scan_layers=False)
    cfg = tiny_test(bidirectional=True, seq_len=16, scan_layers=False)
    tokens, labels = _cls_data()
    for pool in ("first", "mean"):
        jc = jx.gpt.EncoderClassifier(cfg_j, num_classes=ENCODER_CLASSES, pool=pool)
        model = EncoderClassifier(cfg, ENCODER_CLASSES, pool=pool, device="cpu", seed=2)
        params = _to_jax(jx, model)
        want = jax.jit(lambda p: jc.apply({"params": p}, tokens, train=False))(params)
        np.testing.assert_allclose(_logits(model, tokens), np.asarray(want), **TOL)
    jloss = jmake("data")
    jgrads = jax.jit(jax.grad(lambda p: jloss(p, jc.apply, JBatch(inputs=jnp.asarray(tokens),
                                                                  labels=jnp.asarray(labels)),
                                              jax.random.PRNGKey(1))[0]))(params)
    loss_fn = make_classification_loss("data")
    batch = Batch(inputs=_port(tokens).long(), labels=_port(labels).long())
    loss, _ = loss_fn(model, batch, torch.Generator().manual_seed(0))
    _assert_grads(_grads(model, loss), jgrads, cfg)
    funcs = build_train_functions(make_model_init(model, AdamW(lambda count: 1e-2)), loss_fn,
                                  None)
    state = funcs.init_fn(None, params_from_jax(_np(params), cfg, dtype=torch.float32))
    history = []
    for _ in range(ENCODER_CLS_STEPS + 1):
        state, metrics = funcs.step_fn(state, None, batch)
        history.append((compute(metrics)["loss"], compute(metrics)["accuracy"]))
    assert history[-1][0] < history[0][0] and history[-1][1] > 0.5, history[-1]


def _cls_data():
    rng = np.random.default_rng(4)
    return (rng.integers(0, 256, (16, 16)).astype(np.int32),
            rng.integers(0, ENCODER_CLASSES, 16).astype(np.int32))


def test_encoder_classifier_refuses_causal_and_masks_mean_pool(jx):
    """A causal config is refused with JAX's ValueError; mean pooling over
    the first segment ignores the second segment's tokens, as JAX's (whose
    logits it matches)."""
    jax, jnp = jx.jax, jx.jnp
    tokens = np.zeros((2, 16), np.int32)
    with pytest.raises(ValueError, match="bidirectional") as want:
        jx.gpt.EncoderClassifier(jx.gpt.tiny_test(dtype=jnp.float32, remat=False),
                                 num_classes=2).init(jax.random.PRNGKey(0), jnp.asarray(tokens),
                                                     train=False)
    with pytest.raises(ValueError, match="bidirectional") as got:
        EncoderClassifier(tiny_test(), 2, device="cpu")
    assert str(got.value) == str(want.value)
    overrides = dict(bidirectional=True, seq_len=16, scan_layers=False, n_layers=1)
    jc = jx.gpt.EncoderClassifier(jx.gpt.tiny_test(dtype=jnp.float32, remat=False, **overrides),
                                  num_classes=3, pool="mean")
    toks = _tokens(2, 16, seed=6)
    seg = np.concatenate([np.zeros((2, 8), np.int32), np.ones((2, 8), np.int32)], axis=1)
    cfg = tiny_test(**overrides)
    model = EncoderClassifier(cfg, 3, pool="mean", device="cpu", seed=0)
    params = _to_jax(jx, model)
    base = _logits(model, toks, segment_ids=seg)
    toks2 = toks.copy()
    toks2[:, 8:] = (toks2[:, 8:] + 5) % 256
    np.testing.assert_allclose(_logits(model, toks2, segment_ids=seg), base, **TOL)
    np.testing.assert_allclose(base, np.asarray(jc.apply(
        {"params": params}, jnp.asarray(toks), segment_ids=jnp.asarray(seg), train=False)), **TOL)


def test_bidirectional_window_matches_dense(jx):
    """Encoder local attention: ``bidirectional_flash_attention`` with the
    symmetric band |q - k| < window against JAX's dense reference (windows
    16, 48, 100), and its gradients at window 48."""
    rng = np.random.default_rng(8)
    q, k, v = (rng.standard_normal((1, 256, 2, 16)).astype(np.float32) for _ in range(3))
    for window in (16, 48, 100):
        got = layers.bidirectional_flash_attention(_port(q), _port(k), _port(v), block_q=32,
                                                   block_k=32, window=window)
        want = jx.layers.causal_attention(jx.jnp.asarray(q), jx.jnp.asarray(k),
                                          jx.jnp.asarray(v), window=window, causal=False)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL, err_msg=str(window))
    leaves = [_port(x).requires_grad_() for x in (q, k, v)]
    (layers.bidirectional_flash_attention(*leaves, window=48) ** 2).sum().backward()
    want = jx.jax.grad(lambda *a: (jx.layers.causal_attention(*a, window=48, causal=False) ** 2)
                       .sum(), argnums=(0, 1, 2))(*(jx.jnp.asarray(x) for x in (q, k, v)))
    for leaf, w, name in zip(leaves, want, "qkv"):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), **GRAD_TOL,
                                   err_msg=f"d{name}")


def test_encoder_local_attention_model(jx):
    """A windowed encoder: flash equals xla equals JAX's at the model level,
    and a token 20 positions away (window 8) cannot move position 0."""
    overrides = dict(bidirectional=True, seq_len=64, attn_window=8, scan_layers=False,
                     n_layers=1)
    tokens = _tokens(1, 64, seed=9)
    jm, params, xla = _bridged(jx, overrides)
    flash = GPTLM(tiny_test(**overrides, attn_impl="flash", flash_block_q=16, flash_block_k=16),
                  device="cpu", seed=None)
    flash.load_state_dict(xla.state_dict())
    want = np.asarray(_japply(jx, jm)(params, tokens, None))
    np.testing.assert_allclose(_logits(xla, tokens), want, **TOL)
    np.testing.assert_allclose(_logits(flash, tokens), want, **TOL)
    tokens2 = tokens.copy()
    tokens2[0, 20] = (tokens2[0, 20] + 1) % 256
    np.testing.assert_allclose(_logits(flash, tokens2)[:, 0], _logits(flash, tokens)[:, 0], **TOL)


def test_bert_configs_match_jax(jx):
    """``bert_base`` and ``bert_base_hf`` hold JAX's fields (dtype aside),
    and the trainer's registry and the CLI's config take them."""
    from tpu_parallel_torch.configs import CONFIGS, UNPORTED
    from tpu_parallel_torch.models.gpt import bert_base, bert_base_hf
    from tpu_parallel_torch.train_lib import MODEL_REGISTRY

    for port, jax_cfg in ((bert_base(), jx.gpt.bert_base()), (bert_base_hf(), jx.gpt.bert_base_hf())):
        for field in dataclasses.fields(port):
            if field.name != "dtype":
                assert getattr(port, field.name) == getattr(jax_cfg, field.name), field.name
    assert MODEL_REGISTRY["bert_base"] is bert_base
    assert "bert_base_mlm" in CONFIGS and "bert_base_mlm" not in UNPORTED


@pytest.mark.gpu
def test_encoder_flash_on_the_card_matches_xla():
    """On the card: a bf16 encoder's flash path (the CUDA kernels, non-causal
    with padding segments) against its xla path; the loss of a backward
    pass launches each kernel once per layer."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from tpu_parallel_torch.ops import flash_attention as fa

    cfg = tiny_test(bidirectional=True, seq_len=128, d_model=256, n_heads=4, n_layers=2,
                    dtype=torch.bfloat16, attn_impl="flash", remat=False)
    flash = GPTLM(cfg, device="cuda", seed=0)
    xla = GPTLM(dataclasses.replace(cfg, attn_impl="xla"), device="cuda", seed=0)
    tokens = torch.from_numpy(_tokens(4, 128)).long().cuda()
    seg = torch.from_numpy(_padding(4, 128, 1)).cuda()
    before = (fa.flash_fwd_launches, fa.flash_bwd_launches)
    out = flash(tokens, segment_ids=seg)
    out.float().square().mean().backward()
    assert (fa.flash_fwd_launches - before[0], fa.flash_bwd_launches - before[1]) == (2, 2)
    with torch.no_grad():
        want = xla(tokens, segment_ids=seg).float()
    real = seg == 0
    assert (out.detach().float()[real] - want[real]).abs().max().item() < 0.1


# -- the 8-rank group ---------------------------------------------------------


def _jax_mlm(jx, name):
    """(params, batch, mask, one-device gradients) of an MLM mesh case: the
    port's seeded weights as JAX's tree, JAX's tokens and its one-device
    mask draw, and JAX's gradients of the objective the mesh's synced
    gradients make: each (data, seq) shard's token mean over the mask,
    averaged over the shards.  Cached per case; one jitted gradient per
    model config."""
    if name in jx.cache:
        return jx.cache[name]
    jax, jnp = jx.jax, jx.jnp
    from tpu_parallel.data import lm_batch

    overrides, sizes, rows = ENCODER_MLM[name]
    ref = {k: v for k, v in overrides.items() if k not in ("attn_impl", "num_microbatches")}
    jm, params, _ = _bridged(jx, ref, seed=3)
    batch = lm_batch(jax.random.PRNGKey(0), rows, jm.config.seq_len, jm.config.vocab_size)
    mask = np.asarray(jax.random.bernoulli(jax.random.fold_in(jax.random.PRNGKey(1), 17),
                                           MASK_RATE, batch.tokens.shape))
    data, seq = sizes.get("data", 1), sizes.get("seq", 1)
    r, t = rows // data, mask.shape[1] // seq
    weight = np.zeros(mask.shape, np.float32)
    for d in range(data):
        for s in range(seq):
            block = mask[d * r:(d + 1) * r, s * t:(s + 1) * t]
            weight[d * r:(d + 1) * r, s * t:(s + 1) * t] = block / max(block.sum(), 1) / (data * seq)
    key = tuple(sorted(ref.items()))
    if key not in jx.cache:
        def objective(p, tokens, targets, w):
            return (jx.ce(jm.apply({"params": p}, tokens, train=False), targets) * w).sum()

        jx.cache[key] = jax.jit(jax.grad(objective))
    corrupted = jnp.where(mask, jm.config.vocab_size - 1, batch.tokens)
    grads = jx.cache[key](params, corrupted, batch.tokens, weight)
    tokens = np.asarray(batch.tokens)
    jx.cache[name] = params, {"tokens": tokens, "targets": tokens}, mask, grads
    return jx.cache[name]


def _jax_classifier(jx):
    """(params, tokens, labels, JAX's one-device gradients of the
    classification loss) for the classifier's mesh case."""
    if "cls" in jx.cache:
        return jx.cache["cls"]
    jax, jnp = jx.jax, jx.jnp
    from tpu_parallel.core.losses import make_classification_loss
    from tpu_parallel.core.state import Batch

    jc = jx.gpt.EncoderClassifier(jx.gpt.tiny_test(bidirectional=True, seq_len=16,
                                                   dtype=jnp.float32, remat=False,
                                                   scan_layers=False),
                                  num_classes=ENCODER_CLASSES)
    tokens, labels = _cls_data()
    params = _to_jax(jx, EncoderClassifier(tiny_test(bidirectional=True, seq_len=16,
                                                     scan_layers=False),
                                           ENCODER_CLASSES, device="cpu", seed=2))
    loss = make_classification_loss("data")
    grads = jax.jit(jax.grad(lambda p: loss(p, jc.apply, Batch(inputs=jnp.asarray(tokens),
                                                               labels=jnp.asarray(labels)),
                                            jax.random.PRNGKey(1))[0]))(params)
    jx.cache["cls"] = params, tokens, labels, grads
    return jx.cache["cls"]


def _op_inputs():
    rng = np.random.default_rng(12)
    q, k, v = (rng.standard_normal((1, 128, 4, 16)).astype(np.float32) for _ in range(3))
    return q, k, v, _packed(1, 128, 13), 24


@pytest.fixture(scope="module")
def ranks(jx, tmp_path_factory):
    def make_inputs(outdir):
        inputs = {}
        for name in ENCODER_MLM:
            params, batch, mask, _ = _jax_mlm(jx, name)
            inputs.update(flat_tree(f"{name}_params", _np(params)))
            inputs.update(flat_tree(f"{name}_batch", batch))
            inputs[f"{name}_mask"] = mask
        params, tokens, labels, _ = _jax_classifier(jx)
        inputs.update(flat_tree("cls_params", _np(params)))
        inputs["cls_tokens"], inputs["cls_labels"] = tokens, labels
        q, k, v, seg, window = _op_inputs()
        inputs.update(op_q=q, op_k=k, op_v=v, op_seg=seg, op_window=np.array(window))
        return inputs

    return run_once("encoder", tmp_path_factory, make_inputs, num_ranks=NUM_RANKS)


def _merged(ranks, prefix):
    out = {}
    for rank in ranks:
        for key, value in rank.items():
            if key.startswith(prefix + "/"):
                out.setdefault(key[len(prefix) + 1:], value)
    return out


def _mlm_case(jx, ranks, name):
    """Every rank's synced gradients (a pipe rank its stage's, a model rank
    its slices gathered) against JAX's; losses fall on every rank."""
    *_, jgrads = _jax_mlm(jx, name)
    overrides = ENCODER_MLM[name][0]
    cfg = tiny_test(**{k: v for k, v in overrides.items() if k != "num_microbatches"})
    want = params_from_jax(_np(jgrads), cfg, dtype=torch.float32)
    got = _merged(ranks, f"{name}_grads")
    assert sorted(got) == sorted(want)
    for key, value in got.items():
        np.testing.assert_allclose(value, want[key].numpy(), **GRAD_TOL, err_msg=key)
    for out in ranks:
        losses = out[f"{name}_losses"]
        assert np.all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def test_mlm_training_decreases_loss(jx, ranks):
    """``tests/test_encoder.py:76``: MLM over data=8."""
    _mlm_case(jx, ranks, "dp")


def test_mlm_tp_training(jx, ranks):
    """``:103``: MLM over data 4 x model 2, the CE vocab-parallel."""
    _mlm_case(jx, ranks, "tp")


def test_mlm_training_under_pp(jx, ranks):
    """``:376`` on the post-norm variant over data 2 x model 2 x pipe 2: the
    first stage's embedding norm, no final norm on the last."""
    _mlm_case(jx, ranks, "pp")
    for out in ranks:
        assert not any("norm_final" in n for n in out["pp_params"])


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_mlm_training_under_sp(jx, ranks, impl):
    """``:245``: MLM under ring and Ulysses over data 2 x seq 4."""
    _mlm_case(jx, ranks, impl)


def test_encoder_local_attention_under_ring(jx, ranks):
    """``:432``: a window of 24 under the ring over data 2 x seq 4."""
    _mlm_case(jx, ranks, "ring_window")


def test_postnorm_mlm_training(jx, ranks):
    """``:402``: post-norm, the embedding LayerNorm and erf gelu over
    data=8; the trunk has no final norm."""
    _mlm_case(jx, ranks, "postnorm")
    for out in ranks:
        assert "embed.norm.weight" in out["postnorm_params"]
        assert not any("norm_final" in n for n in out["postnorm_params"])


def test_mlm_mask_folds_over_data_and_seq(ranks):
    """Over data 2 x model 2 x seq 2 the model ranks draw the same mask and
    the data and seq ranks their own (JAX's fold over data and seq)."""
    by_coord = {}
    for out in ranks:
        d, m, s = (int(x) for x in out["mask_coord"])
        by_coord[(d, m, s)] = out["mask"]
    for (d, m, s), mask in by_coord.items():
        np.testing.assert_array_equal(mask, by_coord[(d, 0, s)])
    distinct = {by_coord[(d, 0, s)].tobytes() for d in range(2) for s in range(2)}
    assert len(distinct) == 4


def test_encoder_classifier_finetunes_over_data(jx, ranks):
    """``:145``: ``EncoderClassifier`` over data=8: the synced step-1
    gradients are JAX's one-device ones; the loss falls and the accuracy
    passes 0.5 within 25 steps, equal on every rank."""
    *_, jgrads = _jax_classifier(jx)
    cfg = tiny_test(bidirectional=True, seq_len=16, scan_layers=False)
    want = params_from_jax(_np(jgrads), cfg, dtype=torch.float32)
    for out in ranks:
        got = {k[len("cls_grads/"):]: v for k, v in out.items() if k.startswith("cls_grads/")}
        assert sorted(got) == sorted(want)
        for key, value in got.items():
            np.testing.assert_allclose(value, want[key].numpy(), **GRAD_TOL, err_msg=key)
        history = out["cls_history"]
        np.testing.assert_array_equal(history, ranks[0]["cls_history"])
        assert history[-1][0] < history[0][0] and history[-1][1] > 0.5, history[-1]


def test_bidirectional_ring_matches_dense(jx, ranks):
    """``:206``: the non-causal ring, plain and flash-composed, on packed
    rows over data 2 x seq 4, each rank's block against JAX's dense
    bidirectional attention."""
    q, k, v, seg, _ = _op_inputs()
    want = np.asarray(jx.layers.causal_attention(*(jx.jnp.asarray(x) for x in (q, k, v)),
                                                 segment_ids=jx.jnp.asarray(seg), causal=False))
    for out in ranks:
        j = int(out["op_seq"])
        block = want[:, j * 32:(j + 1) * 32]
        for impl in ("ring_plain", "ring_flash"):
            np.testing.assert_allclose(out[f"op_{impl}"], block, **TOL, err_msg=impl)


def test_bidirectional_window_under_ulysses(jx, ranks):
    """``:344``: Ulysses with the bidirectional flash inner attention and a
    window of 24 over data 2 x seq 4 against JAX's dense reference."""
    q, k, v, _, window = _op_inputs()
    want = np.asarray(jx.layers.causal_attention(*(jx.jnp.asarray(x) for x in (q, k, v)),
                                                 window=window, causal=False))
    for out in ranks:
        j = int(out["op_seq"])
        np.testing.assert_allclose(out["op_ulysses_window"], want[:, j * 32:(j + 1) * 32], **TOL)
