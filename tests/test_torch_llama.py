"""Port parity: the Llama family (rope, RMSNorm, the gated MLPs, head_dim
as Llama sets it) and FSDP x TP (a tensor-parallel slice split again over
the data axis: ``llama_1b_3d``'s data x model x pipe mesh) against the JAX
package.

In-process cases run on bridged ``tiny_test`` weights (fp32, CPU):
``apply_rope``, RMSNorm and the swiglu and geglu MLPs as modules; the
model with rope + rmsnorm + swiglu on the xla and flash (plain) paths,
with GQA, geglu and unrolled layers; greedy ``generate()``
(``tests/test_generate.py:25``'s llama and gqa variants, ragged rope with
a window, ``:680``); the engine's rope variant (``tests/test_serving.py:51``)
over fixed-slot, paged and unified ticks and a spec tick; one training
step's loss and gradients against JAX's one-device step; the bridge's
leaves.  The multi-rank cases run once, in one 8-rank gloo group
(``tests/torch_dp_worker.py``, suite ``llama``): ring and Ulysses with
rope on data=2 x seq=4 against JAX's one-device loss and gradients (the
seq blocks' position offset), and ``tests/test_gpt.py:150`` with
``fsdp=True`` on data=2 x model=2 x pipe=2 against JAX on the same mesh
(each rank's slices against JAX's device shards, losses, synced
gradients, a checkpoint round trip, the export's refusal).

Tolerances (fp32): elementwise outputs and logits 1e-5 (rtol and atol);
gradients rtol 1e-4, atol 1e-6 (``tests/test_tp.py``); training losses
rtol 1e-5; slices and checkpoints bitwise; greedy tokens exactly.
"""

import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch_dp_worker import (LLAMA, LLAMA_3D_STEPS, LLAMA_GEN, LLAMA_SP, flat_tree,
                             nested_tree, run_once)

from tpu_parallel import serving as jserving
from tpu_parallel.core import compute as jax_compute
from tpu_parallel.core.state import TextBatch as JTextBatch
from tpu_parallel.data import lm_batch as jax_lm_batch
from tpu_parallel.models import GPTLM as JGPTLM
from tpu_parallel.models import gpt as jgpt
from tpu_parallel.models import layers as jlayers
from tpu_parallel.models.generate import generate as jax_generate
from tpu_parallel.models.generate import generate_sharded as jax_generate_sharded
from tpu_parallel.parallel import fsdp as jfsdp
from tpu_parallel.runtime import MeshConfig as JMeshConfig
from tpu_parallel.runtime import make_mesh as jax_make_mesh
from tpu_parallel.train_lib import Trainer as JTrainer
from tpu_parallel.train_lib import TrainerConfig as JTrainerConfig
from tpu_parallel_torch import serving as tserving
from tpu_parallel_torch.core.state import TextBatch
from tpu_parallel_torch.models import GPTLM, layers, tiny_test
from tpu_parallel_torch.models.convert import params_from_jax, params_to_jax
from tpu_parallel_torch.models.generate import generate
from tpu_parallel_torch.models.gpt import make_gpt_loss

# one torch intra-op thread per test process (pytest-xdist shares the cores)
torch.set_num_threads(1)

NUM_RANKS = 8
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _unbox(tree):
    return jax.tree.map(lambda x: np.asarray(x.value if isinstance(x, nn.Partitioned) else x),
                        tree, is_leaf=lambda x: isinstance(x, nn.Partitioned))


def _jmesh(**sizes):
    return jax_make_mesh(JMeshConfig(**sizes), devices=jax.devices()[:NUM_RANKS])


def _bridged(overrides, seed=1, rows=2, length=12):
    """A JAX tiny model of ``overrides`` (fp32, no remat), its params, the
    port's model on them and a prompt."""
    jm = JGPTLM(jgpt.tiny_test(dtype=jnp.float32, remat=False, **overrides))
    prompt = np.random.default_rng(seed).integers(0, 256, (rows, length)).astype(np.int32)
    params = jm.init(jax.random.PRNGKey(seed), jnp.asarray(prompt), train=False)["params"]
    cfg = tiny_test(**overrides)
    model = GPTLM(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), cfg))
    return jm, params, model, prompt


# -- the layers ---------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope_matches_jax(dtype):
    """Interleaved pairs at offset and pad (-1) positions; bf16 inputs round
    once, after fp32 products, as JAX's promotion does (1e-5 in fp32,
    bitwise in bf16)."""
    x = np.random.default_rng(0).standard_normal((2, 6, 3, 16)).astype(np.float32)
    pos = np.array([[-1, -1, 0, 1, 2, 3], [100, 101, 102, 103, 104, 105]])
    got = layers.apply_rope(torch.from_numpy(x).to(getattr(torch, dtype)),
                            torch.from_numpy(pos), 500.0)
    want = jlayers.apply_rope(jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(pos), 500.0)
    assert got.dtype == getattr(torch, dtype)
    got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **TOL)


def test_rmsnorm_matches_jax():
    cfg = tiny_test(norm="rmsnorm", norm_eps=1e-6)
    x = np.random.default_rng(1).standard_normal((2, 5, 32)).astype(np.float32) * 3
    scale = np.random.default_rng(2).standard_normal(32).astype(np.float32)
    norm = layers.make_norm(cfg)
    assert isinstance(norm, layers.RMSNorm) and [n for n, _ in norm.named_parameters()] == [
        "weight"]
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(scale))
        got = norm(torch.from_numpy(x)).numpy()
    want = jlayers.make_norm(jgpt.tiny_test(norm="rmsnorm", norm_eps=1e-6), "n").apply(
        {"params": {"scale": jnp.asarray(scale)}}, jnp.asarray(x))
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("mlp", ["swiglu", "geglu"])
def test_gated_mlp_matches_jax(mlp):
    """Bias-free gate, up and down; silu or tanh-gelu on the gate; outputs
    and gradients."""
    jcfg = jgpt.tiny_test(mlp=mlp, dtype=jnp.float32)
    x = np.random.default_rng(3).standard_normal((2, 5, 32)).astype(np.float32)
    jmlp = jlayers.MLP(jcfg)
    params = jmlp.init(jax.random.PRNGKey(4), jnp.asarray(x), train=False)["params"]
    assert set(params) == {"gate", "up", "down"}
    module = layers.MLP(tiny_test(mlp=mlp))
    assert module.down.bias is None and module.gate.bias is None
    with torch.no_grad():
        for name in ("gate", "up", "down"):
            getattr(module, name).weight.copy_(
                torch.from_numpy(np.asarray(params[name]["shard"]["kernel"]).T.copy()))
    xt = torch.from_numpy(x).requires_grad_()
    got = module(xt)
    got.square().sum().backward()
    want, vjp = jax.vjp(lambda p, v: jmlp.apply({"params": p}, v, train=False), params,
                        jnp.asarray(x))
    g_params, g_x = vjp(2 * want)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_x), **GRAD_TOL)
    for name in ("gate", "up", "down"):
        np.testing.assert_allclose(getattr(module, name).weight.grad.numpy(),
                                   np.asarray(g_params[name]["shard"]["kernel"]).T, **GRAD_TOL)


MODEL_VARIANTS = {
    "xla": LLAMA,
    "flash": dict(LLAMA, attn_impl="flash"),
    "gqa": dict(LLAMA, n_kv_heads=2),
    "geglu": dict(LLAMA, mlp="geglu"),
    "unrolled": dict(LLAMA, scan_layers=False),
}


@pytest.mark.parametrize("variant", sorted(MODEL_VARIANTS))
def test_gptlm_llama_matches_jax(variant):
    """``tests/test_gpt.py:235``'s llama forward on bridged weights: logits
    at 1e-5; no ``embed.pos`` table, no norm biases."""
    jm, params, model, prompt = _bridged(MODEL_VARIANTS[variant])
    names = dict(model.named_parameters())
    assert "embed.pos.weight" not in names and not any(
        n.startswith(("norm_final.bias",)) or ".norm_attn.bias" in n for n in names)
    with torch.no_grad():
        got = model(torch.from_numpy(prompt).long()).numpy()
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(prompt), train=False))
    np.testing.assert_allclose(got, want, **TOL)


def test_bridge_llama_leaves_round_trip_and_refuse_a_pos_table():
    """``params_to_jax`` gives JAX's tree (scale without bias, gate/up/down
    without biases, no ``embed/pos``); a tree with an ``embed/pos`` leaf or
    without a gate kernel is refused."""
    for overrides in (LLAMA, dict(LLAMA, scan_layers=False, n_kv_heads=2)):
        jm, params, model, _ = _bridged(overrides)
        tree = params_to_jax(model.state_dict(), model.config)
        want = jax.tree.map(np.asarray, params)
        assert jax.tree.structure(tree) == jax.tree.structure(want)
        for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(tree),
                                     jax.tree_util.tree_leaves_with_path(want)):
            np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(path))
    bad = jax.tree.map(np.asarray, params)
    bad["embed"]["pos"] = {"embedding": np.zeros((32, 32), np.float32)}
    with pytest.raises(ValueError, match="embed/pos"):
        params_from_jax(bad, model.config)
    bad = jax.tree.map(np.asarray, params)
    del bad["blocks"]["layer_0"]["mlp"]["gate"]
    with pytest.raises(KeyError, match="gate"):
        params_from_jax(bad, model.config)


def test_relative_positions_stay_refused():
    """The T5 relative bias is ported: a JAX-initialized relative model's
    logits and greedy tokens are JAX's (``tests/test_torch_seq2seq.py``
    holds its loss and gradients); what stays refused is what JAX refuses,
    in its words: the bias on the flash path and under a pipeline."""
    jm, params, model, prompt = _bridged(dict(positional="relative", scan_layers=False))
    assert "pos" not in params["embed"] and "rel_embedding" in params["rel_bias"]
    with torch.no_grad():
        got = model(torch.from_numpy(prompt).long()).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply({"params": params}, prompt, train=False)),
                               **TOL)
    toks = generate(model, torch.from_numpy(prompt).long(), max_new_tokens=6).numpy()
    np.testing.assert_array_equal(
        toks, np.asarray(jax_generate(jm, params, jnp.asarray(prompt), max_new_tokens=6)))
    for over in (dict(attn_impl="flash"), dict(pipe_size=2)):
        over = dict(positional="relative", **over)
        with pytest.raises(NotImplementedError, match="relative position bias") as want:
            JGPTLM(jgpt.tiny_test(dtype=jnp.float32, **over)).init(
                jax.random.PRNGKey(0), jnp.asarray(prompt), train=False)
        with pytest.raises(NotImplementedError, match="relative position bias") as got:
            GPTLM(tiny_test(**over), device="cpu")
        assert str(got.value) == str(want.value)


# -- generation and serving ---------------------------------------------------


@pytest.mark.parametrize("variant", ["llama", "gqa"])
def test_generate_matches_jax(variant):
    """``tests/test_generate.py:25``'s llama and gqa variants: greedy
    tokens exactly."""
    over = LLAMA if variant == "llama" else dict(LLAMA, n_kv_heads=2)
    jm, params, model, _ = _bridged(over)
    prompt = np.asarray(jax.random.randint(jax.random.PRNGKey(42), (2, 5), 0, 256))
    got = generate(model, torch.from_numpy(prompt).long(), max_new_tokens=8).numpy()
    want = np.asarray(jax_generate(jm, params, jnp.asarray(prompt), max_new_tokens=8,
                                   temperature=0.0))
    np.testing.assert_array_equal(got, want)


def test_ragged_prompts_rope_and_window_match_jax():
    """``tests/test_generate.py:680``: ragged left-padded prompts under rope
    and a 4-token window; exact tokens against JAX's on the same mask, and
    each row equal to its unpadded run."""
    over = dict(positional="rope", norm="rmsnorm", attn_window=4)
    jm, params, model, _ = _bridged(over)
    lens, pad_to = [2, 6], 6
    rows = [np.random.default_rng(9 + i).integers(1, 256, (1, n)) for i, n in enumerate(lens)]
    prompt = np.zeros((2, pad_to), np.int64)
    mask = np.zeros((2, pad_to), bool)
    for i, (r, n) in enumerate(zip(rows, lens)):
        prompt[i, pad_to - n:] = r[0]
        mask[i, pad_to - n:] = True
    got = generate(model, torch.from_numpy(prompt), max_new_tokens=5,
                   prompt_mask=torch.from_numpy(mask)).numpy()
    want = np.asarray(jax_generate(jm, params, jnp.asarray(prompt, jnp.int32), max_new_tokens=5,
                                   prompt_mask=jnp.asarray(mask)))
    np.testing.assert_array_equal(got, want)
    for i, r in enumerate(rows):
        alone = generate(model, torch.from_numpy(r), max_new_tokens=5).numpy()
        np.testing.assert_array_equal(got[i], alone[0], err_msg=f"row {i}")


ENGINE_MODES = {
    "fixed_slot": dict(decode_steps_per_tick=1, unified_tick=False),
    "paged": dict(kv_block_tokens=4, decode_steps_per_tick=1, unified_tick=False),
    "unified": dict(decode_steps_per_tick=4, prefill_chunk_tokens=5),
    "spec": dict(draft_tokens=3),
}


@pytest.mark.parametrize("mode", sorted(ENGINE_MODES))
def test_engine_rope_matches_jax(mode):
    """``tests/test_serving.py:51``'s rope variant through both packages'
    engines with the same knobs: every request's tokens and the event
    stream equal; the paged pool gives every block back."""
    jm, params, model, _ = _bridged(LLAMA)
    rng = np.random.default_rng(5)
    motif = [int(t) for t in rng.integers(1, 256, 3)]
    prompts = [[int(t) for t in rng.integers(1, 256, n)] for n in (3, 9, 14)] + [motif * 4]
    kw = dict(n_slots=2, scheduler=None, prefill_buckets=(4, 8, 16), **ENGINE_MODES[mode])

    def drive(api, eng):
        outs = [eng.add_request(api.Request(prompt=p, max_new_tokens=6, request_id=f"r{i}"))
                for i, p in enumerate(prompts)]
        events = eng.run()
        return [o.tokens for o in outs], [(e.request_id, e.token, e.index) for e in events]

    port = tserving.ServingEngine(model, **kw)
    got = drive(tserving, port)
    want = drive(jserving, jserving.ServingEngine(jm, params, **kw))
    assert got == want
    want_static = generate(model, torch.tensor([prompts[0]]), max_new_tokens=6)[0].tolist()
    assert got[0][0] == want_static
    if mode == "paged":
        port.pool.allocator.check()
        assert port.pool.blocks_in_use == 0
    if mode == "spec":
        assert port.metrics.tokens_drafted > 0


@pytest.mark.parametrize("lazy", [True, False])
def test_generate_beam_rope_matches_jax(lazy):
    """Beam search under rope (lazy ``beam_src`` tables and eager row
    reorders): every beam's cached K holds rope at its absolute position,
    so the tokens equal JAX's exactly and the scores at 1e-5."""
    from tpu_parallel.models.generate import generate_beam as jax_generate_beam
    from tpu_parallel_torch.models.generate import generate_beam

    jm, params, model, _ = _bridged(LLAMA)
    prompt = np.random.default_rng(11).integers(1, 256, (2, 5)).astype(np.int32)
    want_toks, want_scores = jax_generate_beam(jm, params, jnp.asarray(prompt),
                                               max_new_tokens=8, num_beams=4, lazy=lazy,
                                               length_penalty=1.0)
    toks, scores = generate_beam(model.eval(), torch.from_numpy(prompt).long(),
                                 max_new_tokens=8, num_beams=4, lazy=lazy, length_penalty=1.0)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(want_toks))
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_scores), **TOL)


def _radix_engine(api, make):
    return make(n_slots=2, decode_steps_per_tick=1,
                scheduler=api.SchedulerConfig(max_prefills_per_tick=2), kv_block_tokens=4,
                prefix_cache_size=16, kv_radix_cache=True)


def test_radix_prefix_hit_rope_matches_jax():
    """A prompt that shares 8 tokens (two blocks) with an earlier one hits
    the radix tree and reuses K rotated at those positions: every
    request's tokens equal the JAX fixed-slot engine's and the port's own
    fixed-slot engine's."""
    jm, params, model, _ = _bridged(LLAMA)
    rng = np.random.default_rng(13)
    header = [int(t) for t in rng.integers(1, 256, 8)]
    prompts = [header + [5, 9], header + [7, 3, 1], header]
    makes = {"jax": (jserving, lambda **k: jserving.ServingEngine(jm, params, **k)),
             "port": (tserving, lambda **k: tserving.ServingEngine(model.eval(), **k))}

    def tokens(api, eng):
        outs = []
        for i, p in enumerate(prompts):
            outs.append(eng.add_request(api.Request(request_id=f"r{i}", prompt=p,
                                                    max_new_tokens=6)))
            eng.run(max_ticks=200)
        return [list(o.tokens) for o in outs]

    api, make = makes["port"]
    radix = _radix_engine(api, make)
    got = tokens(api, radix)
    fixed = tokens(api, make(n_slots=2, decode_steps_per_tick=1))
    api, make = makes["jax"]
    want = tokens(api, make(n_slots=2, decode_steps_per_tick=1))
    assert got == fixed == want
    assert radix._radix.hits > 0
    radix.pool.allocator.check()


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_prefix_export_import_rope_matches_jax(direction):
    """A mid-flight request exported from one package's radix engine
    (``export_blocks``: K rotated at its absolute positions), sent through
    the wire codecs and imported into the other's (``import_stored``):
    the continuation's greedy tokens equal the exporter's uninterrupted
    run, and both packages' exports of the request agree (K/V at 1e-5,
    positions exactly)."""
    from tpu_parallel.serving import kv_wire as jax_wire
    from tpu_parallel_torch.serving import kv_wire as port_wire
    from tpu_parallel_torch.serving.kv_hierarchy import MIGRATE_IMPORTED

    jm, params, model, _ = _bridged(LLAMA)
    sides = {"jax": (jserving, lambda **k: jserving.ServingEngine(jm, params, **k), jax_wire),
             "port": (tserving, lambda **k: tserving.ServingEngine(model.eval(), **k),
                      port_wire)}
    prompt = [int(t) for t in np.random.default_rng(17).integers(1, 256, 11)]
    exports, delivered, refs = {}, {}, {}
    for name, (api, make, _) in sides.items():
        base = _radix_engine(api, make)
        ref = base.add_request(api.Request(request_id="base", prompt=prompt, max_new_tokens=10))
        base.run(max_ticks=200)
        refs[name] = list(ref.tokens)
        eng = _radix_engine(api, make)
        out = eng.add_request(api.Request(request_id="mid", prompt=prompt, max_new_tokens=10))
        for _ in range(5):
            eng.step()
        exports[name] = eng.export_prefix("mid")
        delivered[name] = list(out.tokens)
    assert refs["jax"] == refs["port"]
    je, pe = exports["jax"], exports["port"]
    assert je.tokens == pe.tokens and je.meta == pe.meta
    for (leaf, _, _), j, p in zip(pe.meta, je.leaves, pe.leaves):
        if leaf == "cached_pos":
            np.testing.assert_array_equal(np.asarray(j), p)
        else:
            np.testing.assert_allclose(p, np.asarray(j), **TOL)
    src, dst = direction.split("_to_")
    moved = sides[dst][2].decode_export(sides[src][2].encode_export(exports[src]))
    api, make, _ = sides[dst]
    eng = _radix_engine(api, make)
    assert eng.import_prefix(moved) == MIGRATE_IMPORTED
    hits = eng._radix.hits
    done = delivered[src]
    cont = eng.add_request(api.Request(request_id="cont", prompt=prompt + done,
                                       max_new_tokens=10 - len(done)))
    eng.run(max_ticks=200)
    assert eng._radix.hits > hits, "the import never produced a hit"
    assert done + list(cont.tokens) == refs[src]


# -- training -----------------------------------------------------------------


def test_train_step_matches_jax():
    """One training step of the llama tiny model (flash plain path,
    ``"proj_attn"`` remat, 2 minibatches) against JAX's one-device step:
    the loss at 1e-5 and every gradient at rtol 1e-4, atol 1e-6."""
    from tpu_parallel_torch.core.accumulate import accumulate_gradients
    from tpu_parallel_torch.core.state import TrainState
    from tpu_parallel_torch.core.optim import AdamW

    over = dict(LLAMA, attn_impl="flash", remat_policy="proj_attn", n_kv_heads=2)
    jcfg = jgpt.tiny_test(dtype=jnp.float32, **over)
    jm = JGPTLM(jcfg)
    batch = jax_lm_batch(jax.random.PRNGKey(0), 4, jcfg.seq_len, jcfg.vocab_size)
    params = jm.init({"params": jax.random.PRNGKey(1)}, batch.tokens, train=False)["params"]
    loss_fn = jgpt.make_gpt_loss(jcfg)
    (loss, _), grads = jax.value_and_grad(
        lambda p: loss_fn(p, jm.apply, batch, jax.random.PRNGKey(0)), has_aux=True)(params)
    cfg = tiny_test(**over)
    model = GPTLM(cfg, device="cpu")
    state = TrainState.create(model, AdamW(lambda c: 1e-3), torch.Generator(),
                              params_from_jax(jax.tree.map(np.asarray, params), cfg,
                                              dtype=torch.float32))
    tb = TextBatch(**{k: torch.from_numpy(np.asarray(v)).long() if v.dtype != jnp.float32
                      else torch.from_numpy(np.asarray(v)) for k, v in vars(batch).items()
                      if v is not None})
    got_grads, metrics = accumulate_gradients(state, tb, state.rng, 2, make_gpt_loss(cfg))
    got_loss = float(metrics["loss"][0] / metrics["loss"][1])
    np.testing.assert_allclose(got_loss, float(loss), **TOL)
    want = params_from_jax(jax.tree.map(np.asarray, grads), cfg, dtype=torch.float32)
    assert sorted(got_grads) == sorted(want)
    for name, g in got_grads.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), **GRAD_TOL, err_msg=name)


# -- the multi-rank cases -----------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_sp(name):
    """One device, ``attn_impl="xla"``: init, batch, loss and gradients of
    the global loss the seq-parallel run computes (every block holds as
    many tokens)."""
    overrides, _ = LLAMA_SP[name]
    cfg = jgpt.tiny_test(**dict(overrides, attn_impl="xla"))
    model = JGPTLM(cfg)
    b = {k: np.asarray(v) for k, v in
         vars(jax_lm_batch(jax.random.PRNGKey(0), 8, cfg.seq_len, 256)).items() if v is not None}
    batch = JTextBatch(**{k: jnp.asarray(v) for k, v in b.items()})
    params = model.init({"params": jax.random.PRNGKey(42)}, batch.tokens, train=False)["params"]
    loss_fn = jgpt.make_gpt_loss(cfg)
    (loss, _), grads = jax.value_and_grad(
        lambda p: loss_fn(p, model.apply, batch, jax.random.PRNGKey(0)), has_aux=True)(params)
    return jax.tree.map(np.asarray, params), b, float(loss), jax.tree.map(np.asarray, grads)


def _lm_init(model, tx):
    def init(rng, batch):
        from tpu_parallel.core.state import TrainState

        v = model.init({"params": rng}, batch.tokens, positions=batch.positions, train=False)
        return TrainState.create(apply_fn=model.apply, params=v["params"], tx=tx, rng=rng)

    return init


@functools.lru_cache(maxsize=None)
def _jax_3d():
    """``tests/test_gpt.py:150`` with ``fsdp=True`` on the llama tiny model
    (data=2 x model=2 x pipe=2): the init (global arrays and each device's
    shards by mesh coordinates), the batch, the step-1 synced gradients,
    the losses of LLAMA_3D_STEPS steps, the masters after them and JAX's
    export error.

    JAX's own ``fsdp=True`` step on this mesh and config aborts XLA:CPU now
    and then (a rendezvous check of two all-gathers that the thunk
    executor runs at once), so the gradients and the steps run JAX's
    ``fsdp=False`` program, the same function, from the ``fsdp=True``
    init's global arrays (which the ``fsdp=False`` init must equal)."""
    from tpu_parallel.parallel.spmd import build_train_functions
    from tpu_parallel.parallel.tp import export_single_device_params

    mesh = _jmesh(data=2, model=2, pipe=2)
    batch = jax_lm_batch(jax.random.PRNGKey(0), 16, 32, 256)
    built = {}
    for fsdp in (True, False):
        cfg = jgpt.tiny_test(pipe_size=2, num_microbatches=2, n_layers=4, fsdp=fsdp,
                             fsdp_min_size=0, **LLAMA)
        model = JGPTLM(cfg)
        loss_fn = jgpt.make_gpt_loss(cfg)
        funcs = build_train_functions(
            _lm_init(model, optax.adamw(3e-3)), loss_fn, mesh, batch, batch_spec=P("data"),
            donate=False, grad_sync_axes=("data", "model"), grad_psum_axes=("pipe",),
            metric_axes=("data", "pipe"), metric_mean_axes=("model",))
        state = jax.block_until_ready(funcs.init_fn(jax.random.PRNGKey(42), batch))
        built[fsdp] = (model, loss_fn, funcs, state)
    state = built[True][3]
    params0 = _unbox(state.params)
    for a, b in zip(jax.tree.leaves(params0), jax.tree.leaves(_unbox(built[False][3].params))):
        np.testing.assert_array_equal(a, b)
    # each device's shard of every leaf, keyed by its (data, model, pipe)
    leaves = jax.tree_util.tree_flatten_with_path(
        state.params, is_leaf=lambda x: isinstance(x, nn.Partitioned))[0]
    leaves = {"/" + "/".join(str(k.key) for k in path):
              (x.value if isinstance(x, nn.Partitioned) else x) for path, x in leaves}
    shards = {}
    for idx in np.ndindex(*mesh.devices.shape):
        coord = dict(zip(mesh.axis_names, idx))
        dev = mesh.devices[idx]
        shards[(coord["data"], coord["model"], coord["pipe"])] = {
            path: a.sharding.devices_indices_map(a.shape)[dev] for path, a in leaves.items()}
    model, loss_fn, funcs, state = built[False]
    specs = nn.get_partition_spec(state.params)

    def grads(p, b, r):
        g, _ = jax.grad(lambda q: loss_fn(q, model.apply, b, r), has_aux=True)(p)
        return jfsdp.sync_gradients(g, ("data", "model"), psum_axes=("pipe",))

    g = jax.block_until_ready(jax.jit(jax.shard_map(
        grads, mesh=mesh, in_specs=(specs, P("data"), P()), out_specs=specs,
        check_vma=False))(state.params, batch, jax.random.PRNGKey(0)))
    losses = []
    for _ in range(LLAMA_3D_STEPS):
        state, m = jax.block_until_ready(funcs.step_fn(state, None, batch))
        losses.append(jax_compute(m)["loss"])
    try:
        export_single_device_params(built[True][3].params)
        error = ""
    except ValueError as exc:
        error = str(exc)
    b = {k: np.asarray(v) for k, v in vars(batch).items() if v is not None}
    return params0, shards, b, _unbox(g), np.array(losses), _unbox(state.params), error


def _gen_prompt():
    rng = np.random.default_rng(5)
    prompt = rng.integers(1, 256, (4, 6)).astype(np.int32)
    mask = np.ones((4, 6), bool)
    mask[1, :2] = False
    mask[3, :4] = False
    return prompt, mask


@functools.lru_cache(maxsize=None)
def _jax_gen(name):
    """``tests/test_generate.py:223`` and ``:453`` with rope: JAX's Trainer
    init of the llama tiny model on LLAMA_GEN[name]'s mesh (data=4 x
    model=2, or data=2 x model=2 x pipe=2: the pipelined decode ring) and
    greedy ``generate_sharded`` on 4 ragged prompts from it."""
    overrides, sizes = LLAMA_GEN[name]
    mesh = _jmesh(**sizes)
    trainer = JTrainer(JTrainerConfig(model="tiny", model_overrides=overrides,
                                      mesh=JMeshConfig(**sizes), global_batch_size=8, steps=1,
                                      donate=False), mesh=mesh)
    state = trainer.init()
    model = JGPTLM(jgpt.tiny_test(**dict(overrides, dtype=jnp.float32, remat=False)))
    prompt, mask = _gen_prompt()
    tokens = jax_generate_sharded(model, state.params, jnp.asarray(prompt), mesh,
                                  max_new_tokens=8, prompt_mask=jnp.asarray(mask))
    return _unbox(state.params), np.asarray(tokens)


def _make_inputs(outdir):
    inputs = {}
    for name in LLAMA_SP:
        params, batch, _, _ = _jax_sp(name)
        inputs.update(flat_tree(f"sp_params_{name}", params))
        inputs.update(flat_tree(f"sp_batch_{name}", batch))
    params0, _, batch, _, _, _, _ = _jax_3d()
    inputs.update(flat_tree("params_3d", params0))
    inputs.update(flat_tree("batch_3d", batch))
    for name in LLAMA_GEN:
        inputs.update(flat_tree(f"gen_params_{name}", _jax_gen(name)[0]))
    inputs["gen_prompt"], inputs["gen_mask"] = _gen_prompt()
    return inputs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_once("llama", tmp_path_factory, _make_inputs, num_ranks=NUM_RANKS)


def _port_config_3d():
    return tiny_test(pipe_size=2, num_microbatches=2, n_layers=4, fsdp=True, fsdp_min_size=0,
                     **LLAMA)


def _merged(ranks, prefix):
    """``{name: array}`` of ``prefix/name`` over the ranks (each pipe
    rank contributes its layers)."""
    out = {}
    for rank in ranks:
        for key, value in rank.items():
            if key.startswith(prefix + "/"):
                out.setdefault(key[len(prefix) + 1:], value)
    return out


@pytest.mark.parametrize("name", sorted(LLAMA_SP))
def test_seq_parallel_rope_matches_jax(ranks, name):
    """Ring and Ulysses with rope on data=2 x seq=4: each rank rotates its
    block at the global positions (the seq coordinate's offset), so the
    loss and the synced gradients are JAX's one-device ones."""
    _, _, loss, grads = _jax_sp(name)
    overrides, _ = LLAMA_SP[name]
    want = params_from_jax(grads, tiny_test(**overrides), dtype=torch.float32)
    for out in ranks:
        np.testing.assert_allclose(float(out[f"sp_{name}_loss"]), loss, rtol=1e-5)
        for key, value in want.items():
            np.testing.assert_allclose(out[f"sp_{name}_grads/{key}"], value.numpy(),
                                       **GRAD_TOL, err_msg=key)


@pytest.mark.parametrize("name", sorted(LLAMA_GEN))
def test_generate_sharded_rope_matches_jax(ranks, name):
    """Greedy ``generate_sharded`` with rope over data=4 x model=2 and
    through the pipelined decode ring (data=2 x model=2 x pipe=2), on
    JAX's init and 4 ragged prompts: JAX's tokens exactly, on every rank
    (a stage that dropped the positions would rotate q and k at the wrong
    place)."""
    want = _jax_gen(name)[1]
    for out in ranks:
        np.testing.assert_array_equal(out[f"gen_{name}"], want)


def test_fsdp_tp_slices_match_jax_shards(ranks):
    """Each rank's slice of every parameter is, element by element, the
    block JAX's device at the same (data, model, pipe) coordinates holds:
    JAX's shard is placed into a NaN-filled tree, bridged with
    ``params_from_jax`` to the rank's model and pipe slice, and the
    non-NaN block must be the rank's tensor.  The data split lands on the
    dim the model axis split (``mlp.gate``, ``mlp.up``, ``mlp.down``,
    ``attn.qkv``, the lm_head) or on the other one (``attn.out``)."""
    params0, shards, _, _, _, _, _ = _jax_3d()
    cfg = _port_config_3d()
    nested = 0
    for out in ranks:
        d, m, p = (int(out[f"coord_{a}"]) for a in ("data", "model", "pipe"))
        index = shards[(d, m, p)]
        placed = {}
        for path, value in flat_tree("", params0).items():
            block = np.full_like(value, np.nan)
            block[index[path]] = value[index[path]]
            placed[path] = block
        bridged = params_from_jax(nested_tree("", placed), cfg, dtype=torch.float32,
                                  model_rank=m, pipe_rank=p)
        local = {k[len("slices/"):]: v for k, v in out.items() if k.startswith("slices/")}
        assert sorted(local) == sorted(bridged)
        for key, value in local.items():
            full = bridged[key].numpy()
            mask = ~np.isnan(full)
            assert mask.sum() == value.size, key
            np.testing.assert_array_equal(full[mask].reshape(value.shape), value, err_msg=key)
            nested += int(str(out[f"spec/{key}"]).count("model") and "(" in str(out[f"spec/{key}"]))
    assert nested > 0


def test_fsdp_tp_training_matches_jax(ranks):
    """``tests/test_gpt.py:150`` with ``fsdp=True``: the losses of every
    step at rtol 1e-5, the step-1 synced gradients (gathered over both
    axes) at rtol 1e-4, atol 1e-6, and the masters after the steps at
    rtol 1e-4, atol 1e-4 (AdamW's first steps move each weight by about the
    learning rate whatever the rounding)."""
    _, _, _, grads, losses, final, _ = _jax_3d()
    cfg = _port_config_3d()
    want_g = params_from_jax(grads, cfg, dtype=torch.float32)
    got_g = _merged(ranks, "grads")
    assert sorted(got_g) == sorted(want_g)
    for key, value in got_g.items():
        np.testing.assert_allclose(value, want_g[key].numpy(), **GRAD_TOL, err_msg=key)
    want_m = params_from_jax(final, cfg, dtype=torch.float32)
    for key, value in _merged(ranks, "final").items():
        np.testing.assert_allclose(value, want_m[key].numpy(), rtol=1e-4, atol=1e-4,
                                   err_msg=key)
    for out in ranks:
        np.testing.assert_allclose(out["losses_3d"], losses, rtol=1e-5)
        assert losses[-1] < losses[0]


def test_fsdp_tp_checkpoint_round_trip(ranks):
    """A sharded checkpoint of the FSDP x TP x PP state (``_StridedShard``
    on the data axis where both axes split one dim) restores bitwise into
    a fresh init, and the next step's loss is the saved run's."""
    for out in ranks:
        assert bool(out["ckpt_bitwise"]) and int(out["ckpt_step"]) == 2
        np.testing.assert_array_equal(out["ckpt_next_loss"][0], out["ckpt_next_loss"][1])


def test_fsdp_tp_export_refused_as_jax(ranks):
    """JAX's ``export_single_device_params`` refuses the state, split over
    a pipe and a model axis of 2; so does the port's, in JAX's words (each
    names the first split leaf it meets: JAX's tree order reaches the
    lm_head's model split first, the port's parameter order a block's pipe
    stage)."""
    import re

    *_, error = _jax_3d()
    pattern = r"split over mesh axis '(pipe|model)' \(size 2\); export requires tp/pipe degree 1"
    assert re.search(pattern, error)
    for out in ranks:
        assert re.search(pattern, str(out["export_error"]))
        assert "run inference under the mesh" in str(out["export_error"])
