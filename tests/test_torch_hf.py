"""Port parity: ``tpu_parallel_torch/models/hf.py`` (GPT-2, Llama, BERT
and T5) and ``tpu_parallel_torch/convert_hf.py`` against the JAX package's
``models/hf.py`` and ``scripts/convert_hf.py``.

Mirrors ``tests/test_hf.py``'s GPT-2, Llama, BERT and T5 cases on the same
random-init HF models (built locally with ``transformers``; nothing is
downloaded): the port's import reproduces the HF model's logits or hidden
states (2e-4, JAX's tolerance against torch), its export loads into a
fresh HF model, and its refusals are JAX's, word for word.  Beside them,
for each family, the port's ``from_hf_*`` is bitwise ``params_from_jax``
of JAX's and its ``to_hf_*`` bitwise JAX's on the bridged tree; and
``python -m tpu_parallel_torch.convert_hf`` on a ``save_pretrained``
directory writes parameters equal to the import and an int8 ``.npz`` whose
bytes are the JAX script's.  T5 covers the original (relu) and v1.1
(gated-gelu) checkpoints, a tied checkpoint without ``lm_head.weight``,
and greedy decoding on the imported weights against HF's ``generate`` and
JAX's tokens.  ``transformers`` and JAX are imported inside the fixtures
only.
"""

import dataclasses
import os
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from tpu_parallel_torch.models import GPTLM, tiny_test
from tpu_parallel_torch.models import hf
from tpu_parallel_torch.models.convert import params_from_jax

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
VOCAB, D, HEADS, LAYERS, SEQ = 96, 32, 4, 3, 48
# port against the HF torch model: JAX's own tolerance in tests/test_hf.py
HF_TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def tf():
    return pytest.importorskip("transformers")


@pytest.fixture(scope="module")
def jx():
    """The JAX package's side: its hf module and config factories."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from tpu_parallel.models import gpt as jgpt
    from tpu_parallel.models import hf as jhf

    return types.SimpleNamespace(hf=jhf, gpt=jgpt, jnp=jnp)


def _hf_gpt2(tf):
    cfg = tf.GPT2Config(vocab_size=VOCAB, n_positions=SEQ, n_embd=D, n_layer=LAYERS,
                        n_head=HEADS, resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)
    torch.manual_seed(0)
    return tf.GPT2LMHeadModel(cfg).eval()


def _hf_llama(tf, kv_heads):
    cfg = tf.LlamaConfig(vocab_size=VOCAB, hidden_size=D, intermediate_size=4 * D,
                         num_hidden_layers=LAYERS, num_attention_heads=HEADS,
                         num_key_value_heads=kv_heads, max_position_embeddings=SEQ,
                         rope_theta=10000.0, rms_norm_eps=1e-5, attention_dropout=0.0)
    torch.manual_seed(0)
    return tf.LlamaForCausalLM(cfg).eval()


def _hf_bert(tf):
    cfg = tf.BertConfig(vocab_size=VOCAB, hidden_size=D, num_hidden_layers=LAYERS,
                        num_attention_heads=HEADS, intermediate_size=4 * D,
                        max_position_embeddings=SEQ, hidden_dropout_prob=0.0,
                        attention_probs_dropout_prob=0.0, hidden_act="gelu")
    torch.manual_seed(0)
    return tf.BertModel(cfg).eval()


_GPT2 = dict(vocab_size=VOCAB, d_model=D, n_heads=HEADS, n_layers=LAYERS, seq_len=SEQ,
             remat=False, scan_layers=False, dropout_rate=0.0)
_LLAMA = dict(positional="rope", norm="rmsnorm", mlp="swiglu")
_BERT = dict(vocab_size=VOCAB, d_model=D, n_heads=HEADS, n_layers=LAYERS, seq_len=SEQ,
             remat=False, dropout_rate=0.0)


def _gpt2_config(**kw):
    return tiny_test(**{**_GPT2, **kw})


def _llama_config(kv_heads, **kw):
    return _gpt2_config(**_LLAMA, n_kv_heads=None if kv_heads == HEADS else kv_heads, **kw)


def _bert_config(**kw):
    from tpu_parallel_torch.models.gpt import bert_base_hf

    return bert_base_hf(**{**_BERT, "dtype": torch.float32, **kw})


def _jax_config(jx, port_config):
    """The JAX GPTConfig of the same fields (fp32)."""
    fields = {f.name: getattr(port_config, f.name) for f in dataclasses.fields(port_config)}
    fields["dtype"] = jx.jnp.float32
    return jx.gpt.GPTConfig(**fields)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree)


def _model(cfg, params):
    model = GPTLM(cfg, device="cpu", seed=None)
    model.load_state_dict(params)
    return model.eval()


def _tokens(rows, seed=0):
    return np.random.default_rng(seed).integers(0, VOCAB, (rows, SEQ))


def _assert_state_equal(got, want):
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype, key
        np.testing.assert_array_equal(got[key].numpy(), value.numpy(), err_msg=key)


def _assert_hf_equal(got, want):
    """The port's HF state dict (tensors) against JAX's (arrays): the same
    keys, bitwise."""
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert got[key].dtype == torch.float32, key
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(value), err_msg=key)


def _canonical(sd):
    out = {}
    for k, v in sd.items():
        if k.endswith(".attn.bias") or k.endswith(".attn.masked_bias"):
            continue  # causal-mask buffers, not parameters
        out[k if k.startswith(("transformer.", "lm_head.")) else f"transformer.{k}"] = v
    return out


def _refusals(fn, *cases):
    """Each ``(args, pattern)`` raises ValueError on both sides with the
    same message; ``fn(side)`` is the side's function."""
    for args, pattern in cases:
        with pytest.raises(ValueError, match=pattern) as want:
            fn("jax")(*args("jax"))
        with pytest.raises(ValueError, match=pattern) as got:
            fn("port")(*args("port"))
        assert str(got.value) == str(want.value)


# --- GPT-2 ---------------------------------------------------------------------


def test_from_hf_logits_match(tf, jx):
    """The import reproduces the HF model's logits and is bitwise
    ``params_from_jax`` of JAX's import."""
    model = _hf_gpt2(tf)
    cfg = _gpt2_config()
    params = hf.from_hf_gpt2(model, cfg)
    _assert_state_equal(params, params_from_jax(_np(jx.hf.from_hf_gpt2(model, _jax_config(jx, cfg))),
                                                cfg))
    tokens = _tokens(2)
    with torch.no_grad():
        want = model(torch.from_numpy(tokens)).logits.numpy()
        got = _model(cfg, params)(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, **HF_TOL)


def test_roundtrip_exact(tf, jx):
    """from_hf then to_hf gives the HF state dict back (atol 1e-6, JAX's),
    and bitwise JAX's ``to_hf_gpt2`` of its own import."""
    model = _hf_gpt2(tf)
    cfg = _gpt2_config()
    sd = hf.to_hf_gpt2(hf.from_hf_gpt2(model, cfg), cfg)
    for key, want in _canonical(model.state_dict()).items():
        np.testing.assert_allclose(sd[key].numpy(), want.numpy(), rtol=0, atol=1e-6, err_msg=key)
    jcfg = _jax_config(jx, cfg)
    _assert_hf_equal(sd, jx.hf.to_hf_gpt2(jx.hf.from_hf_gpt2(model, jcfg), jcfg))


def test_to_hf_loads_into_torch(tf):
    """The export loads into a fresh HF model and reproduces the port's
    logits."""
    model = _hf_gpt2(tf)
    cfg = _gpt2_config()
    params = hf.from_hf_gpt2(model, cfg)
    fresh = _hf_gpt2(tf)
    missing, unexpected = fresh.load_state_dict(hf.to_hf_gpt2(params, cfg), strict=False)
    assert not unexpected, unexpected
    assert all("bias" in m or "masked" in m for m in missing), missing
    tokens = _tokens(1, seed=1)
    with torch.no_grad():
        want = fresh(torch.from_numpy(tokens)).logits.numpy()
        got = _model(cfg, params)(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, **HF_TOL)


def test_from_hf_rejects_structural_mismatch(tf, jx):
    model = _hf_gpt2(tf)

    def cfg(side, **kw):
        port = _gpt2_config(**kw)
        return port if side == "port" else _jax_config(jx, port)

    _refusals(lambda side: hf.from_hf_gpt2 if side == "port" else jx.hf.from_hf_gpt2,
              (lambda s: (model, cfg(s, n_layers=LAYERS - 1)), "layers"),
              (lambda s: (model, cfg(s, seq_len=SEQ * 2)), "position table"),
              (lambda s: (model, cfg(s, norm="rmsnorm")), "norm"),
              (lambda s: (model, cfg(s, scan_layers=True)), "unrolled layout"))


def test_to_hf_pads_truncated_position_table(tf, jx):
    """An import at seq_len < n_positions exports back zero-padded to
    n_positions (torch takes the dict, the trained rows kept), JAX's
    bitwise; truncation is refused."""
    model = _hf_gpt2(tf)
    short = SEQ // 2
    cfg = _gpt2_config(seq_len=short)
    params = hf.from_hf_gpt2(model, cfg)
    assert hf.to_hf_gpt2(params, cfg)["transformer.wpe.weight"].shape[0] == short
    sd = hf.to_hf_gpt2(params, cfg, n_positions=SEQ)
    assert sd["transformer.wpe.weight"].shape[0] == SEQ
    np.testing.assert_array_equal(sd["transformer.wpe.weight"][short:].numpy(), 0.0)
    jcfg = _jax_config(jx, cfg)
    _assert_hf_equal(sd, jx.hf.to_hf_gpt2(jx.hf.from_hf_gpt2(model, jcfg), jcfg,
                                          n_positions=SEQ))
    fresh = _hf_gpt2(tf)
    fresh.load_state_dict(sd)
    np.testing.assert_allclose(fresh.transformer.wpe.weight.detach().numpy()[:short],
                               model.transformer.wpe.weight.detach().numpy()[:short], atol=1e-6)
    with pytest.raises(ValueError, match="refusing to truncate"):
        hf.to_hf_gpt2(params, cfg, n_positions=short // 2)


def test_to_hf_gpt2_refuses_drifted_head(tf, jx):
    """An untied lm_head is refused, as JAX refuses it."""
    model = _hf_gpt2(tf)
    cfg = _gpt2_config()
    jcfg = _jax_config(jx, cfg)
    params = hf.from_hf_gpt2(model, cfg)
    params["lm_head.weight"] = params["lm_head.weight"] + 0.5
    jparams = jx.hf.from_hf_gpt2(model, jcfg)
    jparams["lm_head"]["shard"]["kernel"] = jparams["lm_head"]["shard"]["kernel"] + 0.5
    _refusals(lambda side: hf.to_hf_gpt2 if side == "port" else jx.hf.to_hf_gpt2,
              (lambda s: (params, cfg) if s == "port" else (jparams, jcfg), "drifted apart"))


# --- Llama ---------------------------------------------------------------------


@pytest.mark.parametrize("kv_heads", [HEADS, 2], ids=["mha", "gqa"])
def test_from_hf_llama_logits_match(tf, jx, kv_heads):
    """The import reproduces HF Llama's logits (the rotate-half to
    interleaved permutation, RMSNorm, swiglu, GQA grouping) and is bitwise
    ``params_from_jax`` of JAX's, the fused qkv / kv layout included."""
    model = _hf_llama(tf, kv_heads)
    cfg = _llama_config(kv_heads)
    params = hf.from_hf_llama(model, cfg)
    _assert_state_equal(params, params_from_jax(
        _np(jx.hf.from_hf_llama(model, _jax_config(jx, cfg))), cfg))
    tokens = _tokens(2)
    with torch.no_grad():
        want = model(torch.from_numpy(tokens)).logits.numpy()
        got = _model(cfg, params)(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, **HF_TOL)


def test_from_hf_llama_rejects_mismatch(tf, jx):
    model = _hf_llama(tf, HEADS)

    def pair(port_cfg):
        return lambda s: (model, port_cfg if s == "port" else _jax_config(jx, port_cfg))

    _refusals(lambda side: hf.from_hf_llama if side == "port" else jx.hf.from_hf_llama,
              (pair(_gpt2_config()), "rope"),
              (pair(dataclasses.replace(_llama_config(HEADS), n_kv_heads=2)), "kv heads"),
              (pair(dataclasses.replace(_llama_config(HEADS), norm_eps=1e-6)), "rms_norm_eps"),
              (pair(dataclasses.replace(_llama_config(HEADS), rope_theta=500.0)), "rope_theta"))


def test_from_hf_llama_tied_and_vocab_checks(tf, jx):
    """A tied state dict (no lm_head.weight) takes the token table as the
    lm_head; a vocabulary mismatch is refused in JAX's words."""
    model = _hf_llama(tf, HEADS)
    sd = {k: v for k, v in model.state_dict().items() if k != "lm_head.weight"}
    cfg = _llama_config(HEADS)
    params = hf.from_hf_llama(sd, cfg)
    np.testing.assert_array_equal(params["lm_head.weight"].numpy(),
                                  model.state_dict()["model.embed_tokens.weight"].numpy())
    big = dataclasses.replace(cfg, vocab_size=VOCAB * 2)
    _refusals(lambda side: hf.from_hf_llama if side == "port" else jx.hf.from_hf_llama,
              (lambda s: (sd, big if s == "port" else _jax_config(jx, big)), "embed_tokens"))


@pytest.mark.parametrize("kv_heads", [HEADS, 2], ids=["mha", "gqa"])
def test_to_hf_llama_roundtrip_loads_into_torch(tf, jx, kv_heads):
    """from_hf then to_hf loads into a fresh HF Llama with no key missing or
    extra and reproduces the port's logits; the export is bitwise JAX's."""
    model = _hf_llama(tf, kv_heads)
    cfg = _llama_config(kv_heads)
    params = hf.from_hf_llama(model, cfg)
    sd = hf.to_hf_llama(params, cfg)
    jcfg = _jax_config(jx, cfg)
    _assert_hf_equal(sd, jx.hf.to_hf_llama(jx.hf.from_hf_llama(model, jcfg), jcfg))
    fresh = _hf_llama(tf, kv_heads)
    missing, unexpected = fresh.load_state_dict(sd, strict=False)
    assert not unexpected and not missing, (missing, unexpected)
    tokens = _tokens(1, seed=1)
    with torch.no_grad():
        want = fresh(torch.from_numpy(tokens)).logits.numpy()
        got = _model(cfg, params)(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, **HF_TOL)


@pytest.mark.parametrize("kv_heads,key", [
    (HEADS, "attn.qkv.bias"), (HEADS, "attn.out.bias"), (2, "attn.q.bias"), (2, "attn.kv.bias"),
], ids=["mha-qkv", "mha-out", "gqa-q", "gqa-kv"])
def test_to_hf_llama_refuses_nonzero_bias(tf, jx, kv_heads, key):
    """A non-zero attention bias in any of the four layout branches is
    refused, not dropped, in JAX's words (JAX's tree given the same bias
    through ``params_to_jax``)."""
    from tpu_parallel_torch.models.convert import params_to_jax

    cfg = _llama_config(kv_heads)
    params = hf.from_hf_llama(_hf_llama(tf, kv_heads), cfg)
    params[f"blocks.layer_0.{key}"] = params[f"blocks.layer_0.{key}"] + 0.5
    tree = _np({k: v for k, v in params_to_jax(params, cfg).items()})
    _refusals(lambda side: hf.to_hf_llama if side == "port" else jx.hf.to_hf_llama,
              (lambda s: (params, cfg) if s == "port" else (tree, _jax_config(jx, cfg)),
               "bias"))


def test_to_hf_llama_refuses_non_llama_architecture(jx):
    cfg = _gpt2_config()
    _refusals(lambda side: hf.to_hf_llama if side == "port" else jx.hf.to_hf_llama,
              (lambda s: ({}, cfg if s == "port" else _jax_config(jx, cfg)), "rope"))


# --- BERT ----------------------------------------------------------------------


def test_from_hf_bert_hidden_states_match(tf, jx):
    """The imported trunk reproduces BertModel's last_hidden_state (post-norm
    residuals, the embedding LayerNorm, erf gelu, the token-type-0 fold)
    and, through ``EncoderClassifier``'s pooler, its pooler_output; the
    trunk and the pooler are bitwise JAX's bridged."""
    from tpu_parallel_torch.models.gpt import EncoderClassifier

    model = _hf_bert(tf)
    cfg = _bert_config()
    params, pooler = hf.from_hf_bert(model, cfg)
    jparams, jpooler = jx.hf.from_hf_bert(model, _jax_config(jx, cfg))
    _assert_state_equal(params, params_from_jax(_np(jparams), cfg))
    np.testing.assert_array_equal(pooler["pooler.weight"].numpy(), np.asarray(jpooler["kernel"]).T)
    np.testing.assert_array_equal(pooler["pooler.bias"].numpy(), np.asarray(jpooler["bias"]))
    tokens = _tokens(2)
    with torch.no_grad():
        out = model(input_ids=torch.from_numpy(tokens),
                    token_type_ids=torch.zeros((2, SEQ), dtype=torch.long))
        ours = _model(cfg, params)(torch.from_numpy(tokens), hidden_only=True).numpy()
        clf = EncoderClassifier(cfg, 2, device="cpu", seed=None)
        clf.load_state_dict({**{f"encoder.{k}": v for k, v in params.items()
                                if k != "lm_head.weight"}, **pooler,
                             "classifier.weight": torch.zeros(2, D),
                             "classifier.bias": torch.zeros(2)})
        h = clf.encoder(torch.from_numpy(tokens), hidden_only=True)
        pooled = torch.tanh(clf.pooler(h[:, 0])).numpy()
    np.testing.assert_allclose(ours, out.last_hidden_state.numpy(), **HF_TOL)
    np.testing.assert_allclose(pooled, out.pooler_output.numpy(), **HF_TOL)


def test_from_hf_bert_rejects_mismatch(tf, jx):
    model = _hf_bert(tf)

    def pair(**kw):
        port = _bert_config(**kw)
        return lambda s: (model, port if s == "port" else _jax_config(jx, port))

    _refusals(lambda side: hf.from_hf_bert if side == "port" else jx.hf.from_hf_bert,
              (pair(prenorm=True), "post-norm"),
              (pair(n_layers=LAYERS + 1), "layers"),
              (pair(mlp="gelu"), "gelu_exact"),
              (pair(norm_eps=1e-5), "layer_norm_eps"))


def test_to_hf_bert_roundtrip_loads_into_torch(tf, jx):
    """from_hf then to_hf (the pooler with it; an ``EncoderClassifier``'s
    state dict exports the same) loads into a fresh BertModel and
    reproduces last_hidden_state and pooler_output; the export is bitwise
    JAX's."""
    model = _hf_bert(tf)
    cfg = _bert_config()
    params, pooler = hf.from_hf_bert(model, cfg)
    sd = hf.to_hf_bert(params, cfg, pooler=pooler)
    jcfg = _jax_config(jx, cfg)
    jparams, jpooler = jx.hf.from_hf_bert(model, jcfg)
    _assert_hf_equal(sd, jx.hf.to_hf_bert(jparams, jcfg, pooler=jpooler))
    classifier = {**{f"encoder.{k}": v for k, v in params.items() if k != "lm_head.weight"},
                  **pooler, "classifier.weight": torch.ones(3, D), "classifier.bias": torch.ones(3)}
    _assert_hf_equal(hf.to_hf_bert(classifier, cfg), {k: v.numpy() for k, v in sd.items()})
    fresh = _hf_bert(tf)
    missing, unexpected = fresh.load_state_dict(sd, strict=False)
    assert not unexpected, unexpected
    assert all("position_ids" in m for m in missing), missing
    tokens = _tokens(2, seed=1)
    with torch.no_grad():
        out = fresh(input_ids=torch.from_numpy(tokens),
                    token_type_ids=torch.zeros((2, SEQ), dtype=torch.long))
        ours = _model(cfg, params)(torch.from_numpy(tokens), hidden_only=True)
        pooled = torch.tanh(ours[:, 0] @ pooler["pooler.weight"].T + pooler["pooler.bias"])
    np.testing.assert_allclose(ours.numpy(), out.last_hidden_state.numpy(), **HF_TOL)
    np.testing.assert_allclose(pooled.numpy(), out.pooler_output.numpy(), **HF_TOL)


def test_to_hf_bert_refuses_prenorm(jx):
    cfg = _bert_config(prenorm=True)
    _refusals(lambda side: hf.to_hf_bert if side == "port" else jx.hf.to_hf_bert,
              (lambda s: ({}, cfg if s == "port" else _jax_config(jx, cfg)), "post-norm"))


def test_to_hf_bert_pads_positions_and_refuses_mismatch(tf, jx):
    """A seq_len-sliced import pads the position table back out on export
    (JAX's bitwise; torch takes the dict); a non-BERT architecture is
    refused in JAX's words."""
    model = _hf_bert(tf)
    short = SEQ // 2
    cfg = _bert_config(seq_len=short)
    params, pooler = hf.from_hf_bert(model, cfg)
    sd = hf.to_hf_bert(params, cfg, pooler=pooler, n_positions=SEQ)
    assert sd["embeddings.position_embeddings.weight"].shape[0] == SEQ
    jcfg = _jax_config(jx, cfg)
    jparams, jpooler = jx.hf.from_hf_bert(model, jcfg)
    _assert_hf_equal(sd, jx.hf.to_hf_bert(jparams, jcfg, pooler=jpooler, n_positions=SEQ))
    missing, unexpected = _hf_bert(tf).load_state_dict(sd, strict=False)
    assert not unexpected, unexpected
    gelu = _bert_config(seq_len=short, mlp="gelu")
    _refusals(lambda side: hf.to_hf_bert if side == "port" else jx.hf.to_hf_bert,
              (lambda s: (params, gelu) if s == "port" else (jparams, _jax_config(jx, gelu)),
               "gelu_exact"))


# --- convert_hf ----------------------------------------------------------------


@pytest.mark.parametrize("family", ["gpt2", "llama_gqa"])
def test_convert_hf_matches_jax_script(tf, jx, tmp_path, monkeypatch, family):
    """``python -m tpu_parallel_torch.convert_hf`` on a ``save_pretrained``
    directory (safetensors, read without ``transformers``): ``--format
    torch`` writes the port's import of the model (bitwise), which
    ``GPTLM`` loads; ``--format int8`` writes an ``.npz`` whose bytes are
    those ``scripts/convert_hf.py --format int8`` writes (both runs under
    one clock, for the zip entries' timestamps)."""
    import runpy
    import time

    from tpu_parallel_torch import convert_hf

    model = _hf_gpt2(tf) if family == "gpt2" else _hf_llama(tf, 2)
    src = tmp_path / "hf"
    model.save_pretrained(src)
    assert (src / "model.safetensors").exists()
    assert convert_hf.main([str(src), str(tmp_path / "torch")]) == 0
    cfg, _ = convert_hf.build_config(str(src))
    load = hf.from_hf_gpt2 if family == "gpt2" else hf.from_hf_llama
    params = torch.load(tmp_path / "torch" / "params.pt", weights_only=True)
    _assert_state_equal(params, load(model, cfg, dtype=torch.float32))
    _model(cfg, params)

    now = time.time()
    monkeypatch.setattr(time, "time", lambda: now)
    assert convert_hf.main([str(src), str(tmp_path / "port"), "--format", "int8"]) == 0
    monkeypatch.setattr(sys, "argv", ["convert_hf.py", str(src), str(tmp_path / "jax"),
                                      "--format", "int8"])
    runpy.run_path(str(REPO / "scripts" / "convert_hf.py"), run_name="__main__")
    port = (tmp_path / "port" / "params_int8.npz").read_bytes()
    assert port == (tmp_path / "jax" / "params_int8.npz").read_bytes()
    assert os.path.getsize(tmp_path / "port" / "params_int8.npz") > 0


# --- T5 ------------------------------------------------------------------------


def _hf_t5(tf, act="relu"):
    cfg = tf.T5Config(vocab_size=VOCAB, d_model=D, d_kv=D // HEADS, d_ff=4 * D,
                      num_layers=LAYERS, num_decoder_layers=LAYERS, num_heads=HEADS,
                      relative_attention_num_buckets=8, relative_attention_max_distance=16,
                      dropout_rate=0.0, feed_forward_proj=act, tie_word_embeddings=True)
    torch.manual_seed(0)
    return tf.T5ForConditionalGeneration(cfg).eval()


def _t5_config(**kw):
    from tpu_parallel_torch.models.seq2seq import t5_small_hf

    return t5_small_hf(**{**dict(vocab_size=VOCAB, d_model=D, n_heads=HEADS, n_layers=LAYERS,
                                 enc_layers=LAYERS, seq_len=SEQ, src_seq_len=SEQ,
                                 rel_num_buckets=8, rel_max_distance=16, dtype=torch.float32,
                                 remat=False, dropout_rate=0.0), **kw})


def _jax_t5_config(jx, port_config):
    from tpu_parallel.models.seq2seq import Seq2SeqConfig

    fields = {f.name: getattr(port_config, f.name) for f in dataclasses.fields(port_config)}
    fields["dtype"] = jx.jnp.float32
    return Seq2SeqConfig(**fields)


def _t5_model(cfg, params):
    from tpu_parallel_torch.models.seq2seq import EncoderDecoder

    model = EncoderDecoder(cfg, device="cpu", seed=None)
    model.load_state_dict(params)
    return model.eval()


def _t5_logits(model, src, dst):
    with torch.no_grad():
        return model(torch.from_numpy(src).long(), torch.from_numpy(dst).long()).numpy()


def _t5_inputs():
    rng = np.random.default_rng(3)
    return rng.integers(0, VOCAB, (2, 24)), rng.integers(0, VOCAB, (2, 12))


@pytest.mark.parametrize("act", ["relu", "gated-gelu"], ids=["t5", "t5v11"])
def test_from_hf_t5_logits_match(tf, jx, act):
    """``:369``: the import is bitwise ``params_from_jax`` of JAX's, and
    reproduces HF's seq2seq logits (the relative buckets shared per stack,
    the unscaled-attention fold, RMS norms, relu / geglu, the cross k|v
    interleave, the tied-head rescale)."""
    model_hf = _hf_t5(tf, act)
    cfg = _t5_config(mlp="geglu" if act == "gated-gelu" else "relu")
    params = hf.from_hf_t5(model_hf, cfg)
    _assert_state_equal(params, params_from_jax(
        _np(jx.hf.from_hf_t5(model_hf, _jax_t5_config(jx, cfg))), cfg))
    src, dst = _t5_inputs()
    with torch.no_grad():
        want = model_hf(input_ids=torch.from_numpy(src),
                        decoder_input_ids=torch.from_numpy(dst)).logits.numpy()
    np.testing.assert_allclose(_t5_logits(_t5_model(cfg, params), src, dst), want, **HF_TOL)


def test_from_hf_t5_tied_checkpoint_without_head(tf, jx):
    """A tied checkpoint whose state dict has no ``lm_head.weight``: the head
    is ``shared.T * d_model**-0.5``, bitwise JAX's, with HF's logits."""
    model_hf = _hf_t5(tf)
    sd = {k: v for k, v in model_hf.state_dict().items() if k != "lm_head.weight"}
    cfg = _t5_config()
    params = hf.from_hf_t5(sd, cfg)
    _assert_state_equal(params, params_from_jax(
        _np(jx.hf.from_hf_t5(sd, _jax_t5_config(jx, cfg))), cfg))
    src, dst = _t5_inputs()
    with torch.no_grad():
        want = model_hf(input_ids=torch.from_numpy(src),
                        decoder_input_ids=torch.from_numpy(dst)).logits.numpy()
    np.testing.assert_allclose(_t5_logits(_t5_model(cfg, params), src, dst), want, **HF_TOL)


def test_from_hf_t5_rejects_mismatch(tf, jx):
    """``:400``: JAX's refusals, in its words."""
    model_hf = _hf_t5(tf)

    def fn(side):
        return jx.hf.from_hf_t5 if side == "jax" else hf.from_hf_t5

    def args(**kw):
        cfg = _t5_config(**kw)
        return lambda side: (model_hf, _jax_t5_config(jx, cfg) if side == "jax" else cfg)

    _refusals(fn, (args(positional="learned"), "relative"),
              (args(enc_layers=LAYERS + 1), "num_layers"), (args(dense_bias=True), "dense_bias"),
              (args(n_kv_heads=2), "GQA"), (args(scan_layers=True), "unrolled"),
              (args(norm_eps=1e-5), "layer_norm_epsilon"))


def test_from_hf_t5_greedy_decode_matches_torch(tf, jx):
    """``:412``: greedy decoding on the imported weights (the per-step
    relative bias against every cache slot, the cached cross-attention)
    equals HF's ``generate`` and JAX's tokens."""
    from tpu_parallel.models.seq2seq import EncoderDecoder as JEncoderDecoder
    from tpu_parallel.models.seq2seq import seq2seq_generate as jax_generate
    from tpu_parallel_torch.models.seq2seq import seq2seq_generate

    model_hf = _hf_t5(tf)
    cfg = _t5_config()
    params = hf.from_hf_t5(model_hf, cfg)
    src, _ = _t5_inputs()
    n_new = 8
    with torch.no_grad():
        want = model_hf.generate(input_ids=torch.from_numpy(src), max_new_tokens=n_new,
                                 min_new_tokens=n_new, do_sample=False, decoder_start_token_id=0,
                                 eos_token_id=None).numpy()[:, 1:n_new + 1]
    got = seq2seq_generate(_t5_model(cfg, params), torch.from_numpy(src).long(), bos_id=0,
                           max_new_tokens=n_new).numpy()
    np.testing.assert_array_equal(got, want)
    jcfg = _jax_t5_config(jx, cfg)
    jtoks = jax_generate(JEncoderDecoder(jcfg), jx.hf.from_hf_t5(model_hf, jcfg),
                         jx.jnp.asarray(src), bos_id=0, max_new_tokens=n_new)
    np.testing.assert_array_equal(got, np.asarray(jtoks))


@pytest.mark.parametrize("act", ["relu", "gated-gelu"], ids=["t5", "t5v11"])
def test_to_hf_t5_roundtrip_loads_into_torch(tf, jx, act):
    """``:584``: the export is bitwise JAX's on the bridged tree and loads
    into a fresh untied HF T5 whose logits are the port's."""
    model_hf = _hf_t5(tf, act)
    cfg = _t5_config(mlp="geglu" if act == "gated-gelu" else "relu")
    params = hf.from_hf_t5(model_hf, cfg)
    sd = hf.to_hf_t5(params, cfg)
    jcfg = _jax_t5_config(jx, cfg)
    _assert_hf_equal(sd, jx.hf.to_hf_t5(jx.hf.from_hf_t5(model_hf, jcfg), jcfg))
    untied = tf.T5Config(**{**model_hf.config.to_dict(), "tie_word_embeddings": False})
    fresh = tf.T5ForConditionalGeneration(untied).eval()
    missing, unexpected = fresh.load_state_dict(sd, strict=False)
    assert not unexpected and not missing, (missing, unexpected)
    src, dst = _t5_inputs()
    with torch.no_grad():
        want = fresh(input_ids=torch.from_numpy(src),
                     decoder_input_ids=torch.from_numpy(dst)).logits.numpy()
    np.testing.assert_allclose(_t5_logits(_t5_model(cfg, params), src, dst), want, **HF_TOL)


def test_to_hf_t5_refuses_non_t5_architecture(jx):
    """``:625``: JAX's refusals, in its words."""
    def fn(side):
        return jx.hf.to_hf_t5 if side == "jax" else hf.to_hf_t5

    def args(**kw):
        cfg = _t5_config(**kw)
        return lambda side: ({}, _jax_t5_config(jx, cfg) if side == "jax" else cfg)

    _refusals(fn, (args(positional="learned"), "relative"), (args(dense_bias=True), "dense_bias"),
              (args(scan_layers=True), "unrolled"))


@pytest.mark.parametrize("mlp", ["relu", "geglu"])
def test_t5_round_trip_is_bitwise(mlp):
    """``to_hf_t5`` then ``from_hf_t5`` gives the port's weights back
    bitwise where the attention-scale fold is exact (``head_dim`` a power
    of 4, as ``t5_small_hf``'s 64): seeded weights, relu and geglu."""
    from tpu_parallel_torch.models.seq2seq import EncoderDecoder

    cfg = _t5_config(n_heads=2, mlp=mlp)
    assert cfg.head_dim == 16
    model = EncoderDecoder(cfg, device="cpu", seed=5)
    _assert_state_equal(hf.from_hf_t5(hf.to_hf_t5(model, cfg), cfg), model.state_dict())
