"""Port parity: tensor parallelism (``parallel/tp.py``, the vocab-parallel
CE and argmax, the sync of model-partitioned gradients, the Trainer over a
model axis, ``generate_sharded``, ``_sample_sharded`` and the engine over
a mesh, model-sharded checkpoints and the mesh layout's bridge) against
the JAX package.

The multi-rank cases run once, in one 4-rank gloo group of CPU processes
(``tests/torch_dp_worker.py``, suite ``tp``) on a ``data=2, model=2``
mesh, from JAX's own TP inits (bridged with ``params_from_jax``) and numpy
inputs; JAX runs on ``MeshConfig(data=2, model=2)`` over four of the
suite's simulated devices, so both sides have the same axes.  Tolerances
(fp32), as the JAX tests state them: the layers against dense rtol 1e-5,
atol 1e-5 (the MLP 1e-4), the vocab-parallel CE and its gradient 1e-5,
the synced gradients against dense rtol 1e-4, atol 1e-6
(``tests/test_tp.py``); the Trainer's losses rtol 1e-5 and its assembled
masters rtol 1e-4, atol 1e-5 (``tests/test_fsdp.py``'s
``test_fsdp_matches_dp``), the key slices of the qkv (and GQA's kv) bias left
out (their gradient is rounding noise that AdamW normalizes; ROADMAP §C);
greedy tokens exactly.
"""

import functools
import json

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_dp_worker import NUM_RANKS, flat_tree, nested_tree, run_once

from tpu_parallel.core import compute as jax_compute
from tpu_parallel.data import lm_batch as jax_lm_batch
from tpu_parallel.models import GPTLM as JGPTLM
from tpu_parallel.models import tiny_test as jax_tiny
from tpu_parallel.models.generate import generate_sharded as jax_generate_sharded
from tpu_parallel.runtime import MeshConfig as JMeshConfig
from tpu_parallel.runtime import make_mesh as jax_make_mesh
from tpu_parallel.serving import ServingEngine as JServingEngine
from tpu_parallel.train_lib import Trainer as JTrainer
from tpu_parallel.train_lib import TrainerConfig as JTrainerConfig
from tpu_parallel_torch.models import tiny_test
from tpu_parallel_torch.models.convert import params_from_jax, params_to_jax
from tpu_parallel_torch.parallel import tp

# one torch intra-op thread per test process (pytest-xdist shares the cores)
torch.set_num_threads(1)

TRAINER_KW = dict(model="tiny", global_batch_size=8, num_minibatches=2, steps=4,
                  warmup_steps=2, ema_decay=0.9)
RUNS = ("mha_xla", "mha_flash", "gqa_xla", "gqa_flash")
LAYERS = tiny_test().n_layers


def _mesh22():
    return jax_make_mesh(JMeshConfig(data=2, model=2), devices=jax.devices()[:NUM_RANKS])


def _unbox(tree):
    """A flax params tree as numpy, ``nn.Partitioned`` leaves as their global
    arrays (a TP leaf stacked ``[tp, ...]``)."""
    return jax.tree.map(lambda x: np.asarray(x.value if isinstance(x, nn.Partitioned) else x),
                        tree, is_leaf=lambda x: isinstance(x, nn.Partitioned))


def _overrides(name):
    kind, impl = name.split("_")
    return dict(attn_impl=impl, **({"n_kv_heads": 2} if kind == "gqa" else {}))


# -- the JAX references, each computed once ----------------------------------


@functools.lru_cache(maxsize=None)
def _jax_trainer(name):
    """JAX's Trainer on data=2 x model=2: its TP init (mesh layout), its
    example batch, and 4 steps' losses and final params."""
    trainer = JTrainer(JTrainerConfig(**TRAINER_KW, model_overrides=_overrides(name)),
                       mesh=_mesh22())
    state = trainer.init()
    params0 = _unbox(state.params)
    example = {k: np.asarray(v) for k, v in vars(trainer.example_batch).items() if v is not None}
    losses = []
    for _ in range(4):
        state, metrics = trainer.funcs.step_fn(state, None, trainer.example_batch)
        losses.append(jax_compute(metrics)["loss"])
    return params0, example, losses, _unbox(state.params)


@functools.lru_cache(maxsize=None)
def _jax_generate():
    """``tests/test_generate.py``'s sharded greedy decoding on the mha_xla
    TP init: 4 ragged (left-padded) prompts over data=2 x model=2."""
    trainer = JTrainer(JTrainerConfig(**TRAINER_KW, model_overrides=_overrides("mha_xla")),
                       mesh=_mesh22())
    state = trainer.init()
    model = JGPTLM(jax_tiny(dtype=jnp.float32, remat=False))
    prompt, mask = _gen_prompt()
    tokens = jax_generate_sharded(model, state.params, jnp.asarray(prompt), _mesh22(),
                                  max_new_tokens=8, prompt_mask=jnp.asarray(mask))
    return np.asarray(tokens)


def _gen_prompt():
    rng = np.random.default_rng(5)
    prompt = rng.integers(1, 256, (4, 6)).astype(np.int32)
    mask = np.ones((4, 6), bool)
    mask[1, :2] = False
    mask[3, :4] = False
    return prompt, mask


@functools.lru_cache(maxsize=None)
def _gpt_inputs():
    """A one-device JAX tiny init and a batch of 8 rows (4 per data rank)."""
    cfg = jax_tiny(dtype=jnp.float32)
    batch = jax_lm_batch(jax.random.PRNGKey(0), 8, cfg.seq_len, cfg.vocab_size)
    params = JGPTLM(cfg).init({"params": jax.random.PRNGKey(42)}, batch.tokens,
                              positions=batch.positions, train=False)["params"]
    return (jax.tree.map(np.asarray, params),
            {k: np.asarray(v) for k, v in vars(batch).items() if v is not None})


@functools.lru_cache(maxsize=None)
def _numpy_inputs():
    """The seeded numpy inputs of the layer, loss, sampling and engine
    cases."""
    rng = np.random.default_rng(0)
    return {
        "x16": rng.standard_normal((4, 16)).astype(np.float32),
        "vp_logits": rng.standard_normal((2, 8, 64)).astype(np.float32),
        "vp_targets": rng.integers(0, 64, (2, 8)).astype(np.int64),
        "net/pre.weight": (rng.standard_normal((16, 16)) / 4).astype(np.float32),
        "net/pre.bias": (rng.standard_normal(16) / 4).astype(np.float32),
        "net/up.weight": (rng.standard_normal((32, 16)) / 4).astype(np.float32),
        "net/down.weight": (rng.standard_normal((16, 32)) / 6).astype(np.float32),
        "engine_prompt": rng.integers(1, 256, (2, 5)).astype(np.int32),
        "sample_logits": (rng.standard_normal(64) * 2).astype(np.float32),
        "gen_prompt": _gen_prompt()[0], "gen_mask": _gen_prompt()[1],
        "col_cot": rng.standard_normal((4, 8)).astype(np.float32),
    }


def _make_inputs(outdir):
    gparams, gbatch = _gpt_inputs()
    inputs = {**_numpy_inputs(), **flat_tree("gparams", gparams), **flat_tree("gbatch", gbatch)}
    for name in RUNS:
        params0, example, _, _ = _jax_trainer(name)
        inputs.update(flat_tree(f"tparams_{name}", params0))
        inputs.update(flat_tree(f"example_{name}", example))
    return inputs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_once("tp", tmp_path_factory, _make_inputs)


def _leaves(out, prefix):
    return {k[len(prefix) + 1:]: v for k, v in out.items() if k.startswith(prefix + "/")}


def _not_key(key, cfg):
    """The entries of an attention bias other than its key slices: the key
    bias's gradient is zero in exact arithmetic (softmax ignores a shift
    that is the same for every key), so AdamW steps it by rounding noise.
    The qkv bias holds ``[q | k | v]`` per head, GQA's kv bias ``[k | v]``
    per kv head; every other leaf is kept whole."""
    dh = cfg.head_dim
    if key.endswith("attn.qkv.bias"):
        return (np.arange(3 * cfg.d_model) % (3 * dh)) // dh != 1
    if key.endswith("attn.kv.bias"):
        return (np.arange(2 * cfg.n_kv_heads * dh) % (2 * dh)) // dh != 0
    return slice(None)


# -- the 4-rank group: tests/test_tp.py's layers -------------------------------


def test_column_parallel_matches_dense(ranks):
    for out in ranks:
        w = _leaves(out, "col_w")
        want = _x16() @ w["weight"].T + w["bias"]
        np.testing.assert_allclose(out["col_out"], want, rtol=1e-5, atol=1e-5)
        assert tuple(out["col_local_shape/weight"]) == (4, 16)


def _x16():
    return _numpy_inputs()["x16"]


def test_column_gather_backward_is_reduce_scatter(ranks):
    """The gathered column's backward is JAX's ``psum_scatter`` (one
    reduce-scatter, no all-reduce): each rank of the model axis receives
    the sum over the ranks of its columns' cotangent, so under a
    replicated loss the assembled gradient is tp x the dense one."""
    inputs = _numpy_inputs()
    x, cot = inputs["x16"], inputs["col_cot"]
    for out in ranks:
        g = _leaves(out, "col_g")
        np.testing.assert_allclose(g["weight"], 2 * cot.T @ x, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(g["bias"], 2 * cot.sum(0), rtol=1e-5, atol=1e-5)
        assert out["col_gather_collectives"].tolist() == [1, 0, 1]


def test_row_parallel_matches_dense(ranks):
    for out in ranks:
        w = _leaves(out, "row_w")
        np.testing.assert_allclose(out["row_out"], _x16() @ w["weight"].T + w["bias"],
                                   rtol=1e-5, atol=1e-5)
        assert tuple(out["row_local_shape/weight"]) == (8, 8)


def test_tp_mlp_matches_dense(ranks):
    for out in ranks:
        w = _leaves(out, "mlp_w")
        h = torch.nn.functional.gelu(torch.from_numpy(
            _x16()[:, :12] @ w["up.weight"].T + w["up.bias"])).numpy()
        np.testing.assert_allclose(out["mlp_out"], h @ w["down.weight"].T + w["down.bias"],
                                   rtol=1e-4, atol=1e-4)


def test_row_bias_added_once(ranks):
    for out in ranks:
        np.testing.assert_allclose(out["row_bias_once"], np.ones((2, 4)), atol=1e-7)


def test_row_init_variance_matches_dense(ranks):
    """Each rank draws its own slice (folded init), the row kernel scaled by
    1/sqrt(tp): the shard's std matches the dense layer's within 15%."""
    for out in ranks:
        shard_std, dense_std = out["row_init_std"]
        assert abs(shard_std - dense_std) / dense_std < 0.15
    w = [_leaves(out, "row_w")["weight"] for out in ranks]
    np.testing.assert_array_equal(w[0], w[1])  # the assembled weight is the mesh's
    assert not np.array_equal(w[0][:, :8], w[0][:, 8:])  # the ranks drew apart


def test_split_over_axis_rejects_indivisible(ranks):
    for out in ranks:
        assert "silently dropped" in str(out["split_error"])


def test_vocab_parallel_ce_matches_gathered(ranks):
    """Loss, argmax and (assembled) gradient against plain CE on the full
    logits: each rank's gradient is tp times the exact one on its own
    columns (the psum's transpose), zero elsewhere."""
    logits = torch.from_numpy(_numpy_inputs()["vp_logits"].copy())
    targets = torch.from_numpy(_numpy_inputs()["vp_targets"].copy())
    logits.requires_grad_(True)
    ce = torch.nn.functional.cross_entropy(logits.reshape(-1, 64), targets.reshape(-1),
                                           reduction="none").reshape(2, 8)
    ce.sum().backward()
    for out in ranks:
        np.testing.assert_allclose(out["vp_ce"], ce.detach().numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(out["vp_pred"], logits.detach().argmax(-1).numpy())
        m = int(out["coords"][1])
        cols = slice(32 * m, 32 * m + 32)
        np.testing.assert_allclose(out["vp_grad"][..., cols] / 2, logits.grad[..., cols].numpy(),
                                   rtol=1e-5, atol=1e-5)
        assert not out["vp_grad"][..., 32 * (1 - m):32 * (1 - m) + 32].any()
        np.testing.assert_array_equal(out["vp_tie"], [1, 1, 1])  # lowest id wins a tie


def test_tp_training_grads_match_dense(ranks):
    """``tests/test_tp.py:212``: the synced gradients equal the dense ones on
    the same logical weights; without the division by the axis size, or
    with a second one, the model-partitioned ones are off by 2x."""
    x = torch.from_numpy(_x16())
    w = {n: torch.from_numpy(_numpy_inputs()[f"net/{n}"].copy()).requires_grad_(True)
         for n in ("pre.weight", "pre.bias", "up.weight", "down.weight")}
    h = torch.nn.functional.gelu(
        torch.nn.functional.linear(x, w["pre.weight"], w["pre.bias"]) @ w["up.weight"].T)
    ((h @ w["down.weight"].T) ** 2).mean().backward()
    for out in ranks:
        good = _leaves(out, "net_grad_good")
        for name, p in w.items():
            np.testing.assert_allclose(good[name], p.grad.numpy(), rtol=1e-4, atol=1e-6,
                                       err_msg=name)
        for fault in ("no_div", "extra_div"):
            got = _leaves(out, f"net_grad_{fault}")
            for name in ("up.weight", "down.weight"):
                assert not np.allclose(got[name], w[name].grad.numpy(), rtol=1e-4, atol=1e-6)
            np.testing.assert_allclose(got["pre.weight"], w["pre.weight"].grad.numpy(),
                                       rtol=1e-4, atol=1e-6)


# -- the tiny GPT ----------------------------------------------------------------


def test_gpt_tp_gradients_match_one_process(ranks):
    """The synced gradients of 2 minibatches on each data rank's rows,
    assembled from the model ranks' slices, against one process's on the
    whole batch; the sharded clip norm counts each leaf once."""
    for out in ranks:
        got, want = _leaves(out, "gpt_grad"), _leaves(out, "gpt_grad_single")
        assert got.keys() == want.keys()
        for name in want:
            np.testing.assert_allclose(got[name], want[name], rtol=1e-4, atol=1e-6,
                                       err_msg=name)
        norm = np.sqrt(sum(float(np.square(g.astype(np.float64)).sum()) for g in want.values()))
        np.testing.assert_allclose(float(out["gpt_grad_norm"]), norm, rtol=1e-5)


def test_tp_metrics_not_multiplied(ranks):
    """Synced over the data axis and averaged over the model axis, the
    loss sum, the token count and the correct count equal one process's on
    the whole batch (summed over the model axis they would be doubled)."""
    for out in ranks:
        for step in out["gpt_metrics"]:
            np.testing.assert_allclose(step, out["gpt_metrics_single"], rtol=1e-5)


def test_gpt_tp_specs_and_shapes(ranks):
    """``test_gpt_tp_training``: the qkv, out, up, down and lm_head weights
    are model-sharded (torch dim 0 for column weights and their biases,
    dim 1 for row weights), each rank holding 1/tp; the rest replicated."""
    for out in ranks:
        specs = json.loads(str(out["gpt_specs"]))
        shapes = json.loads(str(out["gpt_local_shapes"]))
        for i in range(LAYERS):
            p = f"blocks.layer_{i}."
            assert specs[p + "attn.qkv.weight"] == ["model", None]
            assert specs[p + "attn.qkv.bias"] == ["model"]
            assert specs[p + "attn.out.weight"] == [None, "model"]
            assert specs[p + "attn.out.bias"] == [None]
            assert specs[p + "mlp.up.weight"] == ["model", None]
            assert specs[p + "mlp.down.weight"] == [None, "model"]
            assert shapes[p + "attn.qkv.weight"] == [48, 32]
            assert shapes[p + "mlp.down.weight"] == [32, 64]
        assert specs["lm_head.weight"] == ["model", None]
        assert shapes["lm_head.weight"] == [128, 32]
        assert specs["embed.tok.weight"] == [None, None]


@pytest.mark.parametrize("name", RUNS)
def test_trainer_tp_matches_jax(ranks, name):
    """``test_gpt_tp_training`` / ``test_gqa_tp_training`` on the Trainer:
    4 steps from JAX's TP init on data=2 x model=2 give JAX's losses, and
    the masters assembled from the model ranks' slices equal JAX's final
    params; the replicated leaves are bitwise equal on every rank."""
    _, _, losses, final = _jax_trainer(name)
    cfg = tiny_test(**_overrides(name))
    want = params_from_jax(final, cfg, dtype=torch.float32)
    for out in ranks:
        np.testing.assert_allclose(out[f"trainer_{name}_losses"], losses, rtol=1e-5)
        got = _leaves(out, f"trainer_{name}")
        assert got.keys() == want.keys()
        for key, value in want.items():
            keep = _not_key(key, cfg)
            np.testing.assert_allclose(got[key][keep], value.numpy()[keep], rtol=1e-4,
                                       atol=1e-5, err_msg=key)
    rep = [n for n in ranks[0]["trainer_replicated"]]
    for n in rep:
        for out in ranks[1:]:
            np.testing.assert_array_equal(out[f"trainer_rep/{n}"], ranks[0][f"trainer_rep/{n}"])


def test_tp_state_is_sliced(ranks):
    """Every model-partitioned leaf's master, AdamW moment, EMA shadow and
    gradient accumulator holds exactly 1/tp of its split dim."""
    for out in ranks:
        shapes = json.loads(str(out["trainer_shard_shapes"]))
        assert len(shapes) == 6 * LAYERS + 1  # qkv w/b, out w, up w/b, down w; lm_head
        for name, (master, mu, ema, acc, full, dim) in shapes.items():
            want = list(full)
            want[dim] //= 2
            assert master == mu == ema == acc == want, name


def test_tp_collectives_per_step(ranks):
    """Per step of ``tiny`` (4 layers, full remat) in 2 minibatches on the
    model axis: each minibatch's forward runs 2 row all-reduces per layer
    and the CE's 5 (a MAX and 2 SUMs, the argmax's MAX and MIN), its
    backward the rows' 2 per layer, the CE's 2 SUMs, and the recompute's
    attention-out all-reduce per layer (the recompute stops before the MLP
    one: nothing after it is needed); the gradient sync averages the
    replicated leaves over data and model (2) and the shards over data
    (1)."""
    per_minibatch = LAYERS * 2 + 5 + LAYERS * 2 + 2 + LAYERS
    for out in ranks:
        for name in RUNS:
            assert out[f"trainer_{name}_counts"].tolist() == [[2 * per_minibatch, 3]] * 4


def test_remat_policies_pin_allreduces(ranks):
    """The forward alone launches 2 row all-reduces per layer and the CE's
    5; a step adds the backward's (2 per layer, the CE's 2) and, under
    ``full`` and ``dots``, the recompute's attention-out all-reduce per
    layer.  Under ``proj`` and ``proj_attn`` the row outputs are saved and
    the recompute launches no forward collective, as JAX names ``proj``
    after the psum.  Every policy gives the same loss."""
    fwd = LAYERS * 2 + 5
    want = {"full": fwd + 3 * LAYERS + 2, "dots": fwd + 3 * LAYERS + 2,
            "proj": fwd + 2 * LAYERS + 2, "proj_attn": fwd + 2 * LAYERS + 2}
    for out in ranks:
        loss = out["remat_full"][2]
        for policy, step in want.items():
            got = out[f"remat_{policy}"]
            assert got[0] == fwd and got[1] == step, policy
            np.testing.assert_allclose(got[2], loss, rtol=1e-6)


def test_chunked_loss_matches_unchunked(ranks):
    """``loss_chunk`` runs the vocab-parallel CE chunk by chunk: the same
    losses as the unchunked step."""
    for out in ranks:
        np.testing.assert_allclose(out["chunk_losses"][0], out["remat_full"][2], rtol=2e-5)


def test_fsdp_with_tp_and_head_divisibility_refused(ranks):
    """FSDP x TP is ported: the mha_xla Trainer with ``fsdp=True`` (every
    tensor-parallel slice split again over data) gives JAX's TP losses
    from the same init; head counts the model axis does not divide stay
    refused."""
    _, _, losses, _ = _jax_trainer("mha_xla")
    for out in ranks:
        assert int(out["fsdp_tp_nested"]) > 0
        np.testing.assert_allclose(out["fsdp_tp_losses"], losses, rtol=1e-5)
        assert "n_heads=1 not divisible by tp=2" in str(out["divisible_error_heads"])
        assert "n_kv_heads=1 must divide n_heads=4 and be divisible by tp=2" in str(
            out["divisible_error_kv"])


def test_export_refuses_tp_sharded_params(ranks):
    """``tests/test_generate.py:181``: the export refuses a model-split leaf
    with JAX's ``ValueError``."""
    for out in ranks:
        assert "split over mesh axis 'model'" in str(out["export_error"])
        assert "run inference under the mesh" in str(out["export_error"])


def test_params_to_jax_mesh_layout(ranks):
    """Every model rank's state dict goes back to JAX's mesh layout: the
    same paths, shapes and stacking as JAX's trained tree, and bridged
    forth again it gives the assembled masters."""
    _, _, _, final = _jax_trainer("mha_xla")
    cfg = tiny_test()
    out = ranks[0]
    tree = nested_tree("to_jax", out)
    want = dict(flat_tree("t", final))
    got = dict(flat_tree("t", tree))
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].shape == want[key].shape, key
    back = params_from_jax(tree, cfg)
    for key, value in back.items():
        np.testing.assert_array_equal(value.numpy(), out[f"trainer_mha_xla/{key}"])
    for r in range(2):
        sliced = params_from_jax(tree, cfg, model_rank=r)
        assert sliced["lm_head.weight"].shape == (128, 32)
        np.testing.assert_array_equal(sliced["lm_head.weight"].numpy(),
                                      back["lm_head.weight"].numpy()[128 * r:128 * (r + 1)])
        assert sliced["blocks.layer_0.attn.out.weight"].shape == (32, 16)


# -- generation and the engine ----------------------------------------------------


def test_generate_sharded_matches_jax(ranks):
    """``tests/test_generate.py:223``: greedy ``generate_sharded`` tokens on
    4 ragged prompts over data=2 x model=2 are exactly JAX's on the same
    mesh and weights, and plain ``generate``'s on the assembled weights;
    the mesh forward's gathered logits equal the dense ones."""
    want = _jax_generate()
    for out in ranks:
        np.testing.assert_array_equal(out["gen_tokens"], want)
        np.testing.assert_array_equal(out["gen_dense_tokens"], want)
        np.testing.assert_allclose(out["gen_mesh_logits"], out["gen_dense_logits"],
                                   rtol=1e-5, atol=1e-5)


def test_sampled_generate_sharded_same_on_every_rank(ranks):
    """Sampling folds over the data axis only: every rank returns the same
    global tokens for top-k, top-p and pure temperature."""
    for name in ("topk", "topp", "temp"):
        for out in ranks[1:]:
            np.testing.assert_array_equal(out[f"gen_{name}"], ranks[0][f"gen_{name}"])


def test_sample_sharded_matches_full_vocab(ranks):
    """``tests/test_generate.py:575``: greedy is the full-vocabulary argmax;
    top-k never leaves the global top-k; every rank draws the same tokens;
    Gumbel-max temperature sampling tracks the full softmax."""
    for out in ranks:
        assert (out["sample_greedy"] == out["sample_greedy"][0]).all()
    top4 = set(np.argsort(-_sample_row())[:4].tolist())
    for out in ranks:
        np.testing.assert_array_equal(out["sample_greedy"], np.argmax(_sample_row()))
        assert set(out["sample_topk"].tolist()) <= top4
        for name in ("topk", "temp", "topp"):
            np.testing.assert_array_equal(out[f"sample_{name}"], ranks[0][f"sample_{name}"])
    probs = torch.softmax(torch.from_numpy(_sample_row()), -1).numpy()
    freq = np.bincount(ranks[0]["sample_temp"], minlength=64) / 512
    assert np.abs(freq - probs).max() < 0.08


def _sample_row():
    return _numpy_inputs()["sample_logits"]


def test_engine_sharded_tp_matches_generate_sharded(ranks):
    """``test_engine_sharded_tp_matches_static`` over data=2 x model=2 (a
    batch of 2, which the data axis divides; the JAX case's data axis of 4
    does not, ROADMAP §C): the engine's greedy tokens over the mesh equal
    ``generate_sharded``'s and the one-device engine's, per-step ticks, no
    unified tick and no graph; the pool holds 2 of 4 heads per rank; 8
    requests through 2 slots each finish at their budget."""
    for out in ranks:
        np.testing.assert_array_equal(out["engine_tokens"], out["engine_want"])
        np.testing.assert_array_equal(out["engine_tokens"], out["engine_dense_tokens"])
        assert out["engine_status"].tolist() == ["finished"] * 2
        assert out["engine_fused"].tolist() == [1, 0, 0]
        assert out["engine_pool_heads"][0] == 2
        for got, want in out["engine_mixed"]:
            assert got == want
        specs = json.loads(str(out["engine_cache_specs"]))
        assert specs["layer_0/cached_key"] == [None, None, "model", None]
        assert specs["layer_0/cached_pos"] == [None, None]


def test_engine_mesh_limits_match_jax(ranks):
    """Under a mesh the engine keeps JAX's limits with JAX's words: the
    paged pool and ``decode_steps_per_tick`` > 1 are refused."""
    mesh = jax_make_mesh(JMeshConfig(data=1), devices=jax.devices()[:1])
    cfg = jax_tiny(dtype=jnp.float32, remat=False)
    model = JGPTLM(cfg)
    params = model.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 4), jnp.int32),
                        train=False)["params"]
    want = []
    for kw in (dict(kv_block_tokens=8), dict(decode_steps_per_tick=4)):
        with pytest.raises(NotImplementedError) as exc:
            JServingEngine(model, params, n_slots=2, mesh=mesh, **kw)
        want.append(str(exc.value))
    for out in ranks:
        assert out["engine_errors"].tolist() == want


def test_checkpoint_roundtrip_tp(ranks):
    """A model-sharded state (every rank its slices, through
    ``torch.distributed.checkpoint``) restores bitwise into a fresh
    Trainer, which then trains on as the original does."""
    for out in ranks:
        assert int(out["ckpt_step"]) == 2
        assert bool(out["ckpt_bitwise"]) and bool(out["ckpt_module_bitwise"])
        assert int(out["ckpt_sharded_leaves"]) == 6 * LAYERS + 1
        np.testing.assert_array_equal(out["ckpt_more_losses"][0], out["ckpt_more_losses"][1])


# -- in-process --------------------------------------------------------------------


def test_tp_dense_without_mesh_is_linear():
    """With no mesh (or a model axis of 1) ``TPDense`` is a plain ``Linear``
    of the full widths: no tag, no collective."""
    before = tp.tp_allreduce_launches
    for style in ("column", "row"):
        layer = tp.TPDense(16, 8, style=style, generator=torch.Generator().manual_seed(0))
        assert layer.weight.shape == (8, 16) and not hasattr(layer.weight, "_fsdp_shard")
        x = torch.randn(3, 16)
        np.testing.assert_allclose(layer(x).detach().numpy(),
                                   torch.nn.functional.linear(x, layer.weight,
                                                              layer.bias).detach().numpy())
    assert tp.tp_allreduce_launches == before
    assert tp.axis_size_or_none(None, "model") is None
    with pytest.raises(ValueError, match="unknown TPDense style"):
        tp.TPDense(4, 4, style="diagonal")


def test_params_from_jax_mesh_layout_in_process():
    """The bridge reads JAX's mesh layout (scanned and unrolled): the full
    weights are the ranks' slices side by side, each rank's slice is its
    stack entry, and a wrong rank raises."""
    for name in ("mha_xla",):
        params0, _, _, _ = _jax_trainer(name)
        cfg = tiny_test()
        full = params_from_jax(params0, cfg)
        stacked = params0["blocks"]["layers"]["block"]["attn"]["qkv"]["shard"]["sharded"]
        np.testing.assert_array_equal(
            full["blocks.layer_1.attn.qkv.weight"].numpy(),
            np.concatenate(list(stacked["kernel"][1]), axis=-1).T)
        rank1 = params_from_jax(params0, cfg, model_rank=1)
        np.testing.assert_array_equal(rank1["blocks.layer_1.attn.qkv.weight"].numpy(),
                                      stacked["kernel"][1][1].T)
        np.testing.assert_array_equal(rank1["blocks.layer_0.attn.out.bias"].numpy(),
                                      full["blocks.layer_0.attn.out.bias"].numpy())
        with pytest.raises(ValueError, match="model_rank=2 of 2"):
            params_from_jax(params0, cfg, model_rank=2)
        # one process's layout round-trips through the single-device tree
        tree = params_to_jax(full, cfg)
        assert "sharded" not in json.dumps(list(flat_tree("t", tree)))
