"""Port parity: mixture of experts and expert parallelism
(``models/moe.py``, the MoE ``Block``, the balance term of
``make_gpt_loss``, the pipeline's per-tick balance, the bridge's expert
leaves, MoE generation and serving) against the JAX package.

Every function of ``tests/test_moe.py`` has a counterpart here, on
bridged ``tiny_test`` weights (fp32, CPU).  JAX's 8-device meshes become
one 8-rank gloo group of CPU processes (``tests/torch_dp_worker.py``,
suite ``moe``, spawned once for the file) on the same mesh shapes:
data=8, data=4 x model=2, data=2 x pipe=4 and data=2 x seq=2 x model=2;
JAX runs the same cases on the suite's simulated devices, from the same
inits and batches.  The data=2 x seq=2 x model=2 case runs with ring
attention and ``fsdp=True`` on both sides (FSDP x TP: the expert stacks'
model slices split again over data).

Tolerances (fp32): one MoE layer's outputs rtol 2e-4, atol 2e-4 and
gradients rtol 1e-4, atol 1e-5, the balance rtol 1e-5 (as
``tests/test_moe.py`` states them); whole-model logits and losses 1e-5,
router gradients rtol 2e-4, atol 1e-6 (``test_pp_aux_gradient_invariance``);
training losses rtol 1e-4 per step (AdamW's first steps are sign-like,
so a step moves each weight by about the learning rate whatever the
rounding; the routing's drop choices are exact); the index dispatch,
the per-tick bubble zeros and greedy tokens exactly.
"""

import functools
import os
import pathlib
import re
import subprocess
import sys

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch_dp_worker import MOE_EP_KINDS, MOE_TRAIN_CASES, flat_tree, run_once

from tpu_parallel.core import compute as jax_compute
from tpu_parallel.data import lm_batch as jax_lm_batch
from tpu_parallel.models import GPTLM as JGPTLM
from tpu_parallel.models import make_gpt_loss as jax_gpt_loss
from tpu_parallel.models import tiny_test as jax_tiny
from tpu_parallel.runtime import MeshConfig as JMeshConfig
from tpu_parallel.runtime import make_mesh as jax_make_mesh
from tpu_parallel_torch.models import GPTLM, moe, tiny_test
from tpu_parallel_torch.models import layers as tlayers
from tpu_parallel_torch.models.convert import _block_leaves, params_from_jax, params_to_jax
from tpu_parallel_torch.models.gpt import make_gpt_loss
from tpu_parallel_torch.core.state import TextBatch

# one torch intra-op thread per test process (pytest-xdist shares the cores)
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
NUM_RANKS = 8
D = jax_tiny().d_model


def _jmesh(**sizes):
    return jax_make_mesh(JMeshConfig(**sizes), devices=jax.devices()[:NUM_RANKS])


def _unbox(tree):
    """A flax params tree as numpy, ``nn.Partitioned`` leaves as their global
    arrays."""
    return jax.tree.map(lambda x: np.asarray(x.value if isinstance(x, nn.Partitioned) else x),
                        tree, is_leaf=lambda x: isinstance(x, nn.Partitioned))


def _np_batch(batch):
    return {k: np.asarray(v) for k, v in vars(batch).items() if v is not None}


def _text_batch(arrays):
    return TextBatch(tokens=torch.from_numpy(arrays["tokens"]).long(),
                     targets=torch.from_numpy(arrays["targets"]).long(),
                     loss_mask=torch.from_numpy(arrays["loss_mask"]),
                     positions=torch.from_numpy(arrays["positions"]).long())


def _lm_init(model, tx):
    def init(rng, batch):
        from tpu_parallel.core.state import TrainState

        v = model.init({"params": rng}, batch.tokens, positions=batch.positions, train=False)
        return TrainState.create(apply_fn=model.apply, params=v["params"], tx=tx, rng=rng)

    return init


# -- the JAX references, each computed once ----------------------------------


@functools.lru_cache(maxsize=None)
def _jax_train(case):
    """tests/test_moe.py's training case on its mesh: (init params, the
    batch, per-step losses and balances)."""
    from tpu_parallel.parallel.spmd import build_train_functions

    sizes, over, steps, _ = MOE_TRAIN_CASES[case]
    mesh = _jmesh(**sizes)
    cfg = jax_tiny(**over)
    batch = jax_lm_batch(jax.random.PRNGKey(0), 16, cfg.seq_len, cfg.vocab_size)
    model = JGPTLM(cfg)
    sync = ("data", "model") if "model" in sizes else ("data",)
    funcs = build_train_functions(_lm_init(model, optax.adamw(3e-3)), jax_gpt_loss(cfg), mesh,
                                  batch, batch_spec=P("data"), grad_sync_axes=sync,
                                  donate=False)
    state = funcs.init_fn(jax.random.PRNGKey(42), batch)
    params0 = _unbox(state.params)
    losses, bals = [], []
    for _ in range(steps):
        state, m = funcs.step_fn(state, None, batch)
        c = jax_compute(m)
        losses.append(c["loss"])
        bals.append(c["moe_balance"])
    return params0, _np_batch(batch), np.array(losses), np.array(bals)


@functools.lru_cache(maxsize=None)
def _jax_way4():
    """tests/test_moe.py:106 on data=2 x seq=2 x model=2 (ring attention,
    FSDP over data): init params, batch, 9 losses, the last token count."""
    from tpu_parallel.parallel.spmd import build_train_functions

    mesh = _jmesh(data=2, seq=2, model=2)
    cfg = jax_tiny(moe_experts=2, attn_impl="ring", fsdp=True, fsdp_min_size=0, seq_len=64)
    batch = jax_lm_batch(jax.random.PRNGKey(0), 8, cfg.seq_len, cfg.vocab_size)
    model = JGPTLM(cfg)
    funcs = build_train_functions(
        _lm_init(model, optax.adamw(3e-3)), jax_gpt_loss(cfg), mesh, batch,
        batch_spec=P("data", "seq"), grad_sync_axes=("data", "seq", "model"),
        metric_axes=("data", "seq"), metric_mean_axes=("model",), donate=False)
    state = funcs.init_fn(jax.random.PRNGKey(42), batch)
    params0 = _unbox(state.params)
    losses = []
    for _ in range(9):
        state, m = funcs.step_fn(state, None, batch)
        losses.append(jax_compute(m)["loss"])
    return params0, _np_batch(batch), np.array(losses), float(m["loss"][1])


@functools.lru_cache(maxsize=None)
def _jax_a2a_trainer():
    """tests/test_moe.py's all-to-all Trainer on data=4 x model=2: its init,
    example batch and the two 3-step means."""
    from tpu_parallel.train_lib import Trainer, TrainerConfig

    trainer = Trainer(TrainerConfig(
        model="tiny", model_overrides=dict(moe_experts=4, moe_top_k=2, moe_dispatch="alltoall",
                                           dtype=jnp.float32, remat=False, dropout_rate=0.0),
        mesh=JMeshConfig(data=4, model=2), global_batch_size=8, steps=6, log_every=1000,
        donate=False, seed=0), mesh=_jmesh(data=4, model=2))
    state = trainer.init()
    params0 = _unbox(state.params)
    first = trainer.train(steps=3)["loss"]
    last = trainer.train(steps=3)["loss"]
    return params0, _np_batch(trainer.example_batch), np.array([first, last])


@functools.lru_cache(maxsize=None)
def _jax_moe_layer():
    """One JAX MoEMLP (PRNGKey(7)) on x [2, 8, d]: its params, x, w_out, and
    per routing kind the one-device output; top-1's gradients of sum(y * w)."""
    from tpu_parallel.models.moe import MoEMLP

    x = jax.random.normal(jax.random.PRNGKey(42), (2, 8, D), jnp.float32)
    w_out = jax.random.normal(jax.random.PRNGKey(3), x.shape, jnp.float32)
    base = jax_tiny(moe_experts=4, dtype=jnp.float32)
    params = MoEMLP(base).init({"params": jax.random.PRNGKey(7)}, x, train=False)["params"]
    outs = {}
    for kind, over in MOE_EP_KINDS.items():
        cfg = jax_tiny(moe_experts=4, dtype=jnp.float32, **over)
        outs[kind] = np.asarray(MoEMLP(cfg).apply({"params": params}, x, train=False,
                                                  mutable=["losses"])[0])
    grads = {}
    for k in (1, 2):
        layer = MoEMLP(jax_tiny(moe_experts=4, moe_top_k=k, dtype=jnp.float32,
                                moe_capacity_factor=4.0))

        def loss(p, layer=layer):
            y, mods = layer.apply({"params": p}, x, train=False, mutable=["losses"])
            bal = sum(jnp.sum(leaf) for leaf in jax.tree_util.tree_leaves(mods["losses"]))
            return jnp.sum(y * w_out), (y, bal)

        g, (y, bal) = jax.grad(loss, has_aux=True)(params)
        grads[k] = (jax.tree.map(np.asarray, g), np.asarray(y), float(bal))
    return jax.tree.map(np.asarray, params), np.asarray(x), np.asarray(w_out), outs, grads


@functools.lru_cache(maxsize=None)
def _jax_pp():
    """tests/test_moe.py:263's reference on one device: a tiny MoE init,
    8 rows, and the data-mean of the 2-microbatch mean of each data
    shard's gradients (the no-PP side of the test)."""
    cfg1 = jax_tiny(moe_experts=2, dtype=jnp.float32, remat=False, num_microbatches=2,
                    moe_balance_weight=1.0)
    batch = jax_lm_batch(jax.random.PRNGKey(0), 8, cfg1.seq_len, cfg1.vocab_size)
    model = JGPTLM(cfg1)
    params = model.init({"params": jax.random.PRNGKey(0)}, batch.tokens, train=False)["params"]
    loss1 = jax_gpt_loss(cfg1, train=False)
    grad = jax.jit(jax.grad(lambda p, b: loss1(p, model.apply, b, jax.random.PRNGKey(0))[0]))
    total = None
    for i in range(4):  # 2 data shards x 2 microbatches of 2 rows
        mb = jax.tree.map(lambda a: a[2 * i:2 * i + 2], batch)
        g = grad(params, mb)
        total = g if total is None else jax.tree.map(jnp.add, total, g)
    ref = jax.tree.map(lambda a: np.asarray(a) / 4, total)
    return jax.tree.map(np.asarray, params), _np_batch(batch), ref


@functools.lru_cache(maxsize=None)
def _jax_bubble():
    """tests/test_moe.py:390 on data=2 x pipe=4: each rank's stage params
    (a one-layer BlockStack) and the per-rank per-tick sown balance."""
    from tpu_parallel.models.layers import BlockStack
    from tpu_parallel.parallel.pp import PipelineModule

    mesh = _jmesh(data=2, pipe=4)
    cfg = jax_tiny(moe_experts=2, dtype=jnp.float32, remat=False, num_microbatches=2)
    module = PipelineModule(stage_fn=functools.partial(BlockStack, cfg, 1), num_microbatches=2,
                            axis_name="pipe", pass_validity=True)
    x = jax.random.normal(jax.random.PRNGKey(42), (4, 8, cfg.d_model), jnp.float32)
    xt = jnp.tile(x, (2, 1, 1))

    def init(x, r):
        return module.init({"params": r}, x, train=False)["params"]

    rng = jax.random.PRNGKey(42)
    probe = jax.shard_map(init, mesh=mesh, in_specs=(P("data"), P()), out_specs=P(),
                          check_vma=False)
    specs = nn.get_partition_spec(jax.eval_shape(probe, xt, rng))
    params = jax.jit(jax.shard_map(init, mesh=mesh, in_specs=(P("data"), P()),
                                   out_specs=specs, check_vma=False))(xt, rng)

    def per_tick(x, p):
        _, mods = module.apply({"params": p}, x, train=False, mutable=["losses"])
        leaf = jax.tree_util.tree_leaves(mods["losses"])[0]
        return leaf.reshape(leaf.shape[0], -1).sum(-1)[None]

    table = jax.jit(jax.shard_map(per_tick, mesh=mesh, in_specs=(P("data"), specs),
                                  out_specs=P("pipe"), check_vma=False))(xt, params)
    stage = _unbox(params)["stage"]["sharded"]["layers"]["block"]
    flat = dict(flat_tree("", stage))
    per_rank = {}
    for r in range(4):
        for path, key, transpose in _block_leaves(jax_tiny(moe_experts=2)):
            if "/" + path in flat:
                arr = flat["/" + path][r, 0]
            else:  # a tensor-parallel leaf, stacked over the model axis of 1
                arr = flat["/" + path.replace("/shard/", "/shard/sharded/")][r, 0, 0]
            per_rank[f"bubble/{r}/{key}"] = arr.T.copy() if transpose else arr
    return np.asarray(x), per_rank, np.asarray(table)


def _gen_prompt():
    rng = np.random.default_rng(5)
    prompt = rng.integers(1, 256, (4, 6)).astype(np.int32)
    mask = np.ones((4, 6), bool)
    mask[1, :2] = False
    mask[3, :4] = False
    return prompt, mask


def _make_inputs(outdir):
    params, x, w_out, _, _ = _jax_moe_layer()
    inputs = {"moe_x": x, "moe_w": w_out, **flat_tree("moe_p", params)}
    p_dp, b16, _, _ = _jax_train("dp_top1")
    inputs.update(flat_tree("gpt4", p_dp))
    inputs.update(flat_tree("b16", b16))
    inputs.update(flat_tree("gpt4ep", _jax_train("ep_top1")[0]))
    p4, b8s64, _, _ = _jax_way4()
    inputs.update(flat_tree("gpt2e64", p4))
    inputs.update(flat_tree("b8s64", b8s64))
    pa, ba, _ = _jax_a2a_trainer()
    inputs.update(flat_tree("a2a_params", pa))
    inputs.update(flat_tree("a2ab", ba))
    pp_params, b8, _ = _jax_pp()
    inputs.update(flat_tree("gpt2e", pp_params))
    inputs.update(flat_tree("b8", b8))
    bx, per_rank, _ = _jax_bubble()
    inputs["bubble_x"] = bx
    inputs.update(per_rank)
    inputs["gen_prompt"], inputs["gen_mask"] = _gen_prompt()
    return inputs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_once("moe", tmp_path_factory, _make_inputs, num_ranks=NUM_RANKS)


def _port_layer(cfg, params):
    """A one-device port MoEMLP holding JAX's MoEMLP ``params``."""
    layer = moe.MoEMLP(cfg)
    sd = {"router.weight": torch.from_numpy(params["router"]["kernel"].T.copy())}
    for name in ("up", "down"):
        for leaf in ("kernel", "bias"):
            sd[f"experts.{name}.{leaf}"] = torch.from_numpy(params["experts"][name][leaf].copy())
    layer.load_state_dict(sd)
    return layer


def _jax_gpt(cfg_kw, tokens, key=0):
    """A JAX tiny GPT init (fp32, unrolled off) and its logits and sown sum."""
    cfg = jax_tiny(dtype=jnp.float32, remat=False, **cfg_kw)
    model = JGPTLM(cfg)
    params = model.init({"params": jax.random.PRNGKey(key)}, jnp.asarray(tokens),
                        train=False)["params"]
    logits, mods = model.apply({"params": params}, jnp.asarray(tokens), train=False,
                               mutable=["losses"])
    sown = sum(float(jnp.sum(leaf)) for leaf in jax.tree_util.tree_leaves(mods["losses"]))
    return jax.tree.map(np.asarray, params), np.asarray(logits), sown


def _port_gpt(cfg_kw, params):
    cfg = tiny_test(remat=False, **cfg_kw)
    model = GPTLM(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params, cfg))
    return model


# -- tests/test_moe.py, one device --------------------------------------------


def test_moe_forward_shapes_and_balance_loss():
    """tests/test_moe.py:30: logits equal JAX's, and the balance values the
    blocks return sum to JAX's sown sum (>= 0.99 per layer)."""
    tokens = np.random.default_rng(0).integers(0, 256, (2, 16))
    params, want, sown = _jax_gpt(dict(moe_experts=4), tokens)
    model = _port_gpt(dict(moe_experts=4), params)
    balances = []
    with torch.no_grad():
        logits = model(torch.from_numpy(tokens), moe_losses=balances)
    assert logits.shape == (2, 16, 256)
    np.testing.assert_allclose(logits.numpy(), want, rtol=1e-5, atol=1e-5)
    assert len(balances) == tiny_test().n_layers
    total = float(sum(balances))
    np.testing.assert_allclose(total, sown, rtol=1e-5)
    assert total >= 0.99 * tiny_test().n_layers


def test_moe_single_expert_matches_dense_capacity():
    """tests/test_moe.py:46: one expert at capacity factor 2: finite, and
    JAX's logits."""
    kw = dict(moe_experts=1, moe_capacity_factor=2.0)
    tokens = np.random.default_rng(1).integers(0, 256, (2, 16))
    params, want, _ = _jax_gpt(kw, tokens)
    with torch.no_grad():
        got = _port_gpt(kw, params)(torch.from_numpy(tokens)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _layer_case(top_k, cf, shape, router="topk"):
    """JAX MoEMLP (PRNGKey(3)) on x of ``shape``: params, x, its output."""
    from tpu_parallel.models.moe import MoEMLP

    cfg = jax_tiny(moe_experts=4, moe_top_k=top_k, dtype=jnp.float32, moe_capacity_factor=cf,
                   moe_router=router)
    x = jax.random.normal(jax.random.PRNGKey(42), shape, jnp.float32)
    layer = MoEMLP(cfg)
    variables = layer.init({"params": jax.random.PRNGKey(3)}, x, train=False)
    y, mods = layer.apply(variables, x, train=False, mutable=["losses"])
    bal = [float(leaf) for leaf in jax.tree_util.tree_leaves(mods["losses"])]
    return jax.tree.map(np.asarray, variables["params"]), np.asarray(x), np.asarray(y), bal


def _expert(params, e, xt):
    p = params["experts"]
    h = jax.nn.gelu(xt @ p["up"]["kernel"][e] + p["up"]["bias"][e])
    return np.asarray(h @ p["down"]["kernel"][e] + p["down"]["bias"][e])


def test_moe_top2_convex_mixture():
    """tests/test_moe.py:429: top-2 at ample capacity is each token's
    gate-weighted mixture of its two experts; the port equals JAX and that
    mixture."""
    params, x, want, _ = _layer_case(2, 8.0, (2, 8, D))
    with torch.no_grad():
        got = _port_layer(tiny_test(moe_experts=4, moe_top_k=2, moe_capacity_factor=8.0),
                          params)(torch.from_numpy(x))[0].numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    xf = x.reshape(-1, D)
    probs = np.asarray(jax.nn.softmax(xf @ params["router"]["kernel"], axis=-1))
    vals, idx = jax.lax.top_k(probs, 2)
    gates = np.asarray(vals / vals.sum(-1, keepdims=True))
    idx = np.asarray(idx)
    ref = np.stack([gates[t, 0] * _expert(params, idx[t, 0], xf[t])
                    + gates[t, 1] * _expert(params, idx[t, 1], xf[t]) for t in range(len(xf))])
    np.testing.assert_allclose(got.reshape(-1, D), ref, rtol=2e-4, atol=2e-4)


def test_moe_top1_unchanged_by_topk_code():
    """tests/test_moe.py:465: top-1's gate is the raw router probability."""
    params, x, want, _ = _layer_case(1, 8.0, (1, 8, D))
    with torch.no_grad():
        got = _port_layer(tiny_test(moe_experts=4, moe_capacity_factor=8.0),
                          params)(torch.from_numpy(x))[0].numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    xf = x.reshape(-1, D)
    probs = np.asarray(jax.nn.softmax(xf @ params["router"]["kernel"], axis=-1))
    ref = np.stack([probs[t].max() * _expert(params, probs[t].argmax(), xf[t])
                    for t in range(len(xf))])
    np.testing.assert_allclose(got.reshape(-1, D), ref, rtol=2e-4, atol=2e-4)


def test_expert_choice_every_expert_full():
    """tests/test_moe.py:563: each expert takes exactly its capacity of
    distinct tokens, the balance is 0, the output is JAX's and the sum of
    each token's picking experts' gated outputs."""
    params, x, want, bal = _layer_case(1, 1.0, (2, 16, D), router="expert_choice")
    layer = _port_layer(tiny_test(moe_experts=4, moe_router="expert_choice",
                                  moe_capacity_factor=1.0), params)
    with torch.no_grad():
        y, balance = layer(torch.from_numpy(x))
    assert float(balance) == 0.0 and bal == [0.0]
    np.testing.assert_allclose(y.numpy(), want, rtol=2e-4, atol=2e-4)
    xf = x.reshape(-1, D)
    probs = torch.softmax(torch.from_numpy(xf) @ torch.from_numpy(params["router"]["kernel"]),
                          dim=-1)
    capacity = int(1.0 * xf.shape[0] / 4 + 0.999)
    idx = torch.sort(probs.t(), dim=-1, descending=True, stable=True)[1][:, :capacity]
    ref = np.zeros_like(xf)
    for e in range(4):
        assert len(set(idx[e].tolist())) == capacity
        for t in idx[e].tolist():
            ref[t] += float(probs[t, e]) * _expert(params, e, xf[t])
    np.testing.assert_allclose(y.numpy().reshape(-1, D), ref, rtol=2e-4, atol=2e-4)


# -- tests/test_moe.py, on the meshes (the worker's group) ---------------------


@pytest.mark.parametrize("case", list(MOE_TRAIN_CASES) + ["dp_top1_fsdp"])
def test_moe_training_matches_jax(ranks, case):
    """tests/test_moe.py's dp (:58), EP (:80), top-2 (:527) and expert-choice
    (:605) training: the port's per-step losses and balances equal JAX's
    on the same mesh, init and batch, every rank alike, and the loss
    falls.  ``dp_top1_fsdp``: the same run with FSDP on the data mesh.
    The first 4 steps are held at rtol 1e-5; over all steps 1e-3, since
    after a few AdamW steps the two packages' rounding may flip one
    token's routing at a capacity or top-1 boundary (EP's step 7 moved by
    3e-4 that way and came back within 1e-5 of JAX's at step 8)."""
    _, _, want, want_bal = _jax_train(case.replace("_fsdp", ""))
    for rank in ranks:
        for key, ref in ((f"train_{case}_losses", want), (f"train_{case}_bal", want_bal)):
            np.testing.assert_allclose(rank[key][:4], ref[:4], rtol=1e-5)
            np.testing.assert_allclose(rank[key], ref, rtol=1e-3)
    assert rank[f"train_{case}_losses"][-1] < rank[f"train_{case}_losses"][0]


def test_moe_expert_parallel_layout(ranks):
    """tests/test_moe.py:80's layout check: every expert leaf is sharded over
    the model axis (2 of 4 experts per rank); on the data mesh FSDP splits
    the expert stacks by JAX's rule."""
    from tpu_parallel_torch.parallel.fsdp import shard_dim  # JAX's rule, held in test_torch_fsdp

    specs = ranks[0]["ep_expert_specs"]
    assert len(specs) == 4 * tiny_test().n_layers and all("model" in s for s in specs)
    assert tuple(ranks[0]["ep_expert_shapes"]) == (2, D, 4 * D)
    want = shard_dim((4, D, 4 * D), 8, 0)
    assert int(ranks[0]["fsdp_expert_dim"]) == want
    local = [4, D, 4 * D]
    local[want] //= 8
    assert tuple(ranks[0]["fsdp_expert_local"]) == tuple(local)


def test_moe_4way_mesh_dp_sp_ep(ranks):
    """tests/test_moe.py:106 on data=2 x seq=2 x model=2 with ring attention
    and ``fsdp=True`` on both sides (the expert stacks' model slices split
    again over data): JAX's losses, the global token count intact."""
    _, _, want, count = _jax_way4()
    for rank in ranks:
        assert int(rank["way4_nested"]) > 0
        np.testing.assert_allclose(rank["way4_losses"], want, rtol=1e-4)
        assert float(rank["way4_count"]) == count == 8 * 64
    assert want[-1] < want[0]


@pytest.mark.parametrize("kind", list(MOE_EP_KINDS))
def test_moe_ep_matches_single_device(ranks, kind):
    """tests/test_moe.py:135 (top-1), :491 (top-2) and :627 (expert choice):
    one MoE layer with its experts split over model=2 (the local slice and
    one all-reduce) equals the one-device layer on every rank."""
    want = _jax_moe_layer()[3][kind]
    for rank in ranks:
        np.testing.assert_allclose(rank[f"ep_y_{kind}"], want, rtol=2e-4, atol=2e-4)


def test_moe_ep_gradients_match_single_device(ranks):
    """tests/test_moe.py:191: the synced EP gradients (expert leaves divided
    by the axis, the router averaged over it) equal one device's."""
    g = _jax_moe_layer()[4][1][0]
    for rank in ranks:
        np.testing.assert_allclose(rank["ep_g/router.weight"], g["router"]["kernel"].T,
                                   rtol=1e-4, atol=1e-5)
        for name in ("up", "down"):
            for leaf in ("kernel", "bias"):
                np.testing.assert_allclose(rank[f"ep_g/experts.{name}.{leaf}"],
                                           g["experts"][name][leaf], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("top_k", [1, 2])
def test_alltoall_matches_dense(ranks, top_k):
    """tests/test_moe.py:689: at ample capacity the all-to-all dispatch gives
    the dense dispatch's outputs, balance and synced gradients, and both
    give JAX's.  Collectives per forward and backward (the input takes no
    gradient and the balance is outside this loss): the all-to-all runs
    one exchange each way forward and the combine's back, one packed
    balance all-reduce and one row gather; the dense dispatch one
    all-reduce each way."""
    g, y, bal = _jax_moe_layer()[4][top_k]
    for rank in ranks:
        for dispatch in ("dense", "alltoall"):
            np.testing.assert_allclose(rank[f"a2a{top_k}_y_{dispatch}"], y, rtol=2e-4, atol=2e-4)
            np.testing.assert_allclose(float(rank[f"a2a{top_k}_bal_{dispatch}"]), bal,
                                       rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(rank[f"a2a{top_k}_g_{dispatch}/router.weight"],
                                       g["router"]["kernel"].T, rtol=2e-4, atol=1e-5)
            for name in ("up", "down"):
                for leaf in ("kernel", "bias"):
                    np.testing.assert_allclose(
                        rank[f"a2a{top_k}_g_{dispatch}/experts.{name}.{leaf}"],
                        g["experts"][name][leaf], rtol=2e-4, atol=1e-5)
        # (all-to-alls, all-gathers, all-reduces) forward + backward
        assert tuple(rank[f"a2a{top_k}_collectives_alltoall"]) == (3, 1, 1)
        assert tuple(rank[f"a2a{top_k}_collectives_dense"]) == (0, 0, 2)
    assert "expert_choice routing needs the dense dispatch" in str(ranks[0]["a2a_ec_error"])
    assert "not divisible by EP axis size 2" in str(ranks[0]["a2a_tokens_error"])
    assert "moe_experts=3 not divisible by model axis 2" in str(ranks[0]["ep_divide_error"])


def test_alltoall_ep_training_decreases_loss(ranks):
    """tests/test_moe.py:778: the Trainer with the all-to-all dispatch over
    data=4 x model=2 from JAX's Trainer's init and batch: its two 3-step
    means equal JAX's, and fall; 4 x 2 exchanges per layer and step."""
    _, _, want = _jax_a2a_trainer()
    for rank in ranks:
        np.testing.assert_allclose(rank["a2a_trainer_losses"], want, rtol=1e-4)
        assert int(rank["a2a_trainer_alltoalls"]) == 3 * 4 * tiny_test().n_layers
    assert want[1] < want[0]


def test_pp_aux_gradient_invariance(ranks):
    """tests/test_moe.py:263: the router (and a qkv) gradient at pipe 4, two
    microbatches and balance weight 1, synced over data, equals the
    one-device data-mean of the 2-microbatch mean, in JAX and in the port
    (pipe 1) alike."""
    params, batch, ref = _jax_pp()
    blocks = ref["blocks"]["layers"]["block"]
    cfg1 = tiny_test(moe_experts=2, remat=False, num_microbatches=2, moe_balance_weight=1.0)
    model = GPTLM(cfg1, device="cpu")
    model.load_state_dict(params_from_jax(params, cfg1))
    loss1 = make_gpt_loss(cfg1, train=False)
    b = _text_batch(batch)
    for i in range(4):
        loss1(model, b.rows(2 * i, 2 * i + 2))[0].backward()
    for rank in ranks:
        layer = int(rank["coords_p4"][0])  # rank r's stage holds layer r
        for leaf, jax_leaf in (("moe.router.weight", blocks["moe"]["router"]["kernel"]),
                               ("attn.qkv.weight", blocks["attn"]["qkv"]["shard"]["kernel"])):
            want = jax_leaf[layer].T
            np.testing.assert_allclose(rank[f"pp_g/{leaf}"], want, rtol=2e-4, atol=1e-6)
            one = getattr(model.blocks, f"layer_{layer}").get_parameter(leaf).grad / 4
            np.testing.assert_allclose(one.numpy(), want, rtol=2e-4, atol=1e-6)


def test_pp_moe_bubble_ticks_sow_zero(ranks):
    """tests/test_moe.py:390: the per-tick balance table of a one-layer stage
    under data=2 x pipe=4 is JAX's: exactly 0 on bubble ticks, the stage's
    balance (> 0.5) on real ones; the lockstep ``execute_pipeline_step``
    loop gives the same table and the schedule's outputs."""
    _, _, table = _jax_bubble()
    assert table.shape == (4, 2 + 4 - 1)
    for rank in ranks:
        r = int(rank["coords_p4"][0])
        got = rank["bubble_table"]
        np.testing.assert_allclose(got, table[r], rtol=1e-5)
        np.testing.assert_allclose(rank["step_table"], table[r], rtol=1e-5)
        for t in range(table.shape[1]):
            if r <= t < r + 2:
                assert got[t] > 0.5, (r, t, got)
            else:
                assert got[t] == 0.0 and rank["step_table"][t] == 0.0, (r, t, got)
        if r == 3:
            assert float(rank["step_out_err"]) == 0.0


def test_moe_worker_mesh_coords(ranks):
    """The worker's data=4 x model=2 mesh puts model coordinates innermost,
    as JAX's ``make_mesh`` does (what the per-rank comparisons assume)."""
    assert [tuple(r["coords_d4m2"]) for r in ranks] == [(d, m) for d in range(4)
                                                        for m in range(2)]


# -- the port's own cases --------------------------------------------------------


@pytest.mark.parametrize("cf", [0.5, 1.0, 1.25])
@pytest.mark.parametrize("top_k", [1, 2])
def test_index_dispatch_equals_dispatch_masks(cf, top_k):
    """The module's index dispatch makes JAX's drop choices exactly:
    ``dispatch_slots`` as a one-hot mask equals the port's
    ``_dispatch_masks`` and JAX's, the combine too, at capacity factors
    that drop, with tied router rows (identical pads) routed by the lower
    expert index."""
    from tpu_parallel.models import moe as jmoe

    rng = np.random.default_rng(int(cf * 100) + top_k)
    probs = rng.dirichlet(np.ones(4) * 0.7, size=64).astype(np.float32)
    probs[40:48] = probs[40]  # identical rows tie
    probs[50] = [0.4, 0.1, 0.4, 0.1]  # a tie inside a row
    p = torch.from_numpy(probs)
    gates, experts = moe.topk_choices(p, top_k)
    capacity = moe.capacity_for(cf, top_k, 64, 4)
    slots, kept = moe.dispatch_slots(experts, 4, capacity)
    mask = torch.zeros(64, 4 * capacity + 1)
    mask.scatter_(1, slots, 1.0)
    got = mask[:, :-1].view(64, 4, capacity)
    onehots = [torch.nn.functional.one_hot(experts[:, j], 4).float() for j in range(top_k)]
    ref_d, ref_c = moe._dispatch_masks(onehots, gates, 4, capacity)
    assert torch.equal(got, ref_d)
    combine = torch.zeros(64, 4 * capacity + 1)
    combine.scatter_add_(1, slots, gates * kept)
    assert torch.equal(combine[:, :-1].view(64, 4, capacity), ref_c)
    jg, joh = jmoe._topk_gates(jnp.asarray(probs), top_k)
    jd, jc = jmoe._dispatch_masks(joh, jg, 4, capacity)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jd))
    np.testing.assert_allclose(ref_c.numpy(), np.asarray(jc), rtol=1e-6, atol=0)
    assert int(kept.sum()) < 64 * top_k or cf > 1.0  # capacity binds below 1
    assert capacity == max(1, int(cf * top_k * 64 / 4 + 0.999))


def test_capacity_is_jax_expression_not_ceil():
    """JAX's ``int(x + 0.999)``: a fractional part below 0.001 rounds down,
    where ``math.ceil`` would add a slot."""
    assert moe.capacity_for(1.0000005, 1, 1000, 1) == 1000  # 1000.0005: ceil gives 1001
    assert moe.capacity_for(1.25, 1, 4, 8) == 1
    assert moe.capacity_for(1.25, 1, 65536, 8) == 10240


def test_gpt_loss_and_balance_metric_match_jax():
    """``make_gpt_loss`` with MoE: the objective (CE + weight x balance /
    n_layers), the CE and ``moe_balance`` metrics and the router
    gradient equal JAX's ``make_gpt_loss``."""
    cfg_kw = dict(moe_experts=4, moe_capacity_factor=1.0, moe_balance_weight=0.5)
    jcfg = jax_tiny(dtype=jnp.float32, remat=False, **cfg_kw)
    batch = jax_lm_batch(jax.random.PRNGKey(1), 4, jcfg.seq_len, jcfg.vocab_size)
    model_j = JGPTLM(jcfg)
    params = model_j.init({"params": jax.random.PRNGKey(2)}, batch.tokens, train=False)["params"]
    jloss = jax_gpt_loss(jcfg, train=False)
    (jtotal, jmet), jgrad = jax.value_and_grad(
        lambda p: jloss(p, model_j.apply, batch, jax.random.PRNGKey(0)), has_aux=True)(params)
    model = _port_gpt(cfg_kw, jax.tree.map(np.asarray, params))
    total, met = make_gpt_loss(model.config, train=False)(model, _text_batch(_np_batch(batch)))
    total.backward()
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-5)
    for key in ("loss", "moe_balance"):
        np.testing.assert_allclose(float(met[key][0] / met[key][1]),
                                   float(jmet[key][0] / jmet[key][1]), rtol=1e-5)
    router = np.asarray(jgrad["blocks"]["layers"]["block"]["moe"]["router"]["kernel"])
    for i in range(4):
        np.testing.assert_allclose(
            getattr(model.blocks, f"layer_{i}").moe.router.weight.grad.numpy(), router[i].T,
            rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize("policy", ["proj_attn", "full", "dots"])
def test_remat_counts_the_balance_once(policy):
    """Under remat the recompute never records a layer's balance again: the
    loss and the router gradient equal the unchecked model's."""
    tokens = np.random.default_rng(2).integers(0, 256, (2, 33))
    batch = TextBatch(tokens=torch.from_numpy(tokens[:, :-1]),
                      targets=torch.from_numpy(tokens[:, 1:]),
                      loss_mask=torch.ones(2, 32), positions=torch.arange(32).expand(2, 32))
    out = {}
    for remat in (False, True):
        cfg = tiny_test(moe_experts=4, moe_balance_weight=1.0, remat=remat,
                        remat_policy=policy, moe_capacity_factor=1.0)
        model = GPTLM(cfg, device="cpu", seed=3)
        loss, met = make_gpt_loss(cfg)(model, batch)
        loss.backward()
        out[remat] = (float(loss), float(met["moe_balance"][0]),
                      model.blocks.layer_1.moe.router.weight.grad.clone())
    assert out[True][:2] == pytest.approx(out[False][:2], rel=1e-6)
    torch.testing.assert_close(out[True][2], out[False][2], rtol=1e-5, atol=1e-7)


def _jax_ragged_generate(kw):
    from tpu_parallel.models.generate import generate as jgenerate

    prompt, mask = _gen_prompt()
    params, _, _ = _jax_gpt(kw, prompt, key=11)
    tokens = jgenerate(JGPTLM(jax_tiny(dtype=jnp.float32, remat=False, **kw)), params,
                       jnp.asarray(prompt), jax.random.PRNGKey(0), max_new_tokens=8,
                       prompt_mask=jnp.asarray(mask))
    return params, np.asarray(tokens)


def test_ragged_generate_matches_jax_at_binding_capacity(monkeypatch):
    """Greedy ragged ``generate()`` through top-1 MoE at capacity factor 1.0,
    where capacity binds in prefill (24 tokens, 6 slots per expert) and in
    decode (4 rows, 1 slot), gives JAX's tokens: pad rows claim capacity
    in token order, so they must hold JAX's hidden states.  With pad
    positions clamped to row 0 (the port before pads wrapped) the tokens
    differ."""
    from tpu_parallel_torch.models.generate import generate

    kw = dict(moe_experts=4, moe_capacity_factor=1.0)
    params, want = _jax_ragged_generate(kw)
    prompt, mask = _gen_prompt()
    model = _port_gpt(kw, params)
    args = (model, torch.from_numpy(prompt).long())
    got = generate(*args, max_new_tokens=8, prompt_mask=torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, want)
    monkeypatch.setattr(tlayers, "_wrap", lambda index, size: index.clamp(min=0))
    clamped = generate(*args, max_new_tokens=8, prompt_mask=torch.from_numpy(mask)).numpy()
    assert not np.array_equal(clamped, want)


def test_pad_lookups_match_flax():
    """The embedding reads pad positions (-1) and the engine's parked
    sentinel (-2) as flax's lookup does: row ``i + rows``."""
    cfg = tiny_test()
    model = GPTLM(cfg, device="cpu", seed=4)
    emb = model.embed
    tok = torch.tensor([[5, -2, 7]])
    pos = torch.tensor([[0, -1, -2]])
    with torch.no_grad():
        got = emb(tok, pos)
    table = jnp.asarray(emb.pos.weight.detach().numpy())
    vocab = jnp.asarray(emb.tok.weight.detach().numpy())
    flax_pos = nn.Embed(cfg.seq_len, cfg.d_model).apply({"params": {"embedding": table}},
                                                        jnp.asarray(pos.numpy()))
    flax_tok = nn.Embed(cfg.vocab_size, cfg.d_model).apply({"params": {"embedding": vocab}},
                                                           jnp.asarray(tok.numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(flax_pos + flax_tok))


def test_ragged_prefill_hidden_states_match_jax_on_every_row():
    """Left-padded prefill through MoE: every row's hidden state, pads
    included, equals JAX's."""
    kw = dict(moe_experts=4, moe_capacity_factor=1.0)
    prompt, mask = _gen_prompt()
    positions = np.where(mask, np.cumsum(mask, 1) - 1, -1)
    params, _, _ = _jax_gpt(kw, prompt, key=11)
    jmodel = JGPTLM(jax_tiny(dtype=jnp.float32, remat=False, **kw))
    want = jmodel.apply({"params": params}, jnp.asarray(prompt),
                        positions=jnp.asarray(positions), train=False, hidden_only=True)
    with torch.no_grad():
        got = _port_gpt(kw, params)(torch.from_numpy(prompt).long(),
                                    positions=torch.from_numpy(positions), hidden_only=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_generate_sharded_matches_generate(ranks):
    """Greedy ``generate_sharded`` over data=4 x model=2 (experts and heads
    split over model=2) equals one-device ``generate()`` on the same
    weights, on every rank, at ample capacity."""
    from tpu_parallel_torch.models.generate import generate

    cfg_kw = dict(moe_experts=4, moe_capacity_factor=4.0)
    model = _port_gpt(cfg_kw, _jax_train("dp_top1")[0])
    prompt, mask = _gen_prompt()
    want = generate(model, torch.from_numpy(prompt).long(), max_new_tokens=8,
                    prompt_mask=torch.from_numpy(mask)).numpy()
    for rank in ranks:
        np.testing.assert_array_equal(rank["gen_sharded"], want)


def test_engine_greedy_matches_static_generate():
    """The serving engine on a top-1 MoE model at ample capacity (every
    slot's tokens fit, parked rows included): greedy tokens equal static
    ``generate()``'s, per-step and fused ticks alike."""
    from tpu_parallel_torch.models.generate import generate
    from tpu_parallel_torch.serving import Request, SchedulerConfig, ServingEngine

    model = GPTLM(tiny_test(moe_experts=4, moe_capacity_factor=4.0), device="cpu",
                  seed=5).eval()
    rng = np.random.default_rng(9)
    prompts = [rng.integers(1, 256, n).tolist() for n in (5, 9, 3)]
    want = [generate(model, torch.tensor([p]), max_new_tokens=6)[0].tolist() for p in prompts]
    for steps in (1, 4):
        eng = ServingEngine(model, n_slots=4,
                            scheduler=SchedulerConfig(max_prefills_per_tick=4),
                            decode_steps_per_tick=steps)
        outs = [eng.add_request(Request(prompt=p, max_new_tokens=6)) for p in prompts]
        eng.run()
        assert [o.tokens for o in outs] == want


@pytest.mark.parametrize("scan", [True, False])
def test_bridge_round_trips_expert_layouts(scan):
    """``params_from_jax`` / ``params_to_jax`` carry the router and the
    expert stacks both in the one-device layout (``experts/...``, [E, ...])
    and in EP's (``experts/sharded/...``, [ep, E / ep, ...]), scanned and
    unrolled, exactly; a missing or an extra leaf raises."""
    p_ep = _jax_train("ep_top1")[0]  # data=4 x model=2: the mesh layout, scanned
    cfg = tiny_test(moe_experts=4, scan_layers=scan)
    full = params_from_jax(p_ep, cfg)
    ranks = [params_from_jax(p_ep, cfg, model_rank=r) for r in range(2)]
    assert tuple(ranks[1]["blocks.layer_0.moe.experts.up.kernel"].shape) == (2, D, 4 * D)
    torch.testing.assert_close(
        ranks[1]["blocks.layer_2.moe.experts.down.bias"],
        full["blocks.layer_2.moe.experts.down.bias"][2:], rtol=0, atol=0)
    one = params_to_jax(full, cfg)
    back = params_from_jax(one, cfg)
    assert all(torch.equal(back[k], full[k]) for k in full)
    mesh_tree = params_to_jax(ranks, cfg)
    if scan:
        assert jax.tree.structure(mesh_tree) == jax.tree.structure(p_ep)
        for a, b in zip(jax.tree.leaves(mesh_tree), jax.tree.leaves(p_ep)):
            np.testing.assert_array_equal(np.asarray(a), b)
    for r in range(2):
        again = params_from_jax(mesh_tree, cfg, model_rank=r)
        assert all(torch.equal(again[k], ranks[r][k]) for k in ranks[r])
    path = "blocks/layers/block/moe" if scan else "blocks/layer_0/moe"
    node = one
    for name in path.split("/"):
        node = node[name]
    kernel = node["router"].pop("kernel")
    with pytest.raises(KeyError, match="router/kernel"):
        params_from_jax(one, cfg)
    node["router"]["kernel"] = kernel
    node["router"]["bias"] = kernel[..., 0]
    with pytest.raises(ValueError, match="router/bias"):
        params_from_jax(one, cfg)


@pytest.mark.parametrize("scan", [True, False])
def test_swiglu_experts_match_jax(scan):
    """JAX's ``ExpertFFN`` swiglu branch (bias-free gate and up, down with
    its bias) on bridged weights: the model's logits at 1e-5 and the
    bridge's round trip exactly."""
    over = dict(moe_experts=4, mlp="swiglu", positional="rope", norm="rmsnorm",
                scan_layers=scan)
    tokens = np.random.default_rng(3).integers(0, 256, (2, 16)).astype(np.int32)
    jm = JGPTLM(jax_tiny(remat=False, dtype=jnp.float32, **over))
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(4), jnp.asarray(tokens),
                                              train=False)["params"])
    cfg = tiny_test(**over)
    model = GPTLM(cfg, device="cpu")
    state = params_from_jax(params, cfg)
    assert "blocks.layer_0.moe.experts.gate.kernel" in state
    assert "blocks.layer_0.moe.experts.up.bias" not in state
    model.load_state_dict(state)
    with torch.no_grad():
        got = model(torch.from_numpy(tokens).long()).numpy()
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(tokens), train=False))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    back = params_to_jax(model.state_dict(), cfg)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_moe_config_errors_are_jax_errors():
    """JAX's refusals in its words: top-k outside [1, E], an unknown router
    or dispatch, expert-choice decoding, MoE under interleave and under
    1F1B."""
    from tpu_parallel_torch.models.generate import generate
    from tpu_parallel_torch.models.gpt import make_gpt_1f1b_grad_fn

    for k in (0, 5):
        with pytest.raises(ValueError, match=rf"moe_top_k={k} must be in \[1, moe_experts=4\]"):
            tiny_test(moe_experts=4, moe_top_k=k)
    with pytest.raises(ValueError, match="moe_router='switch'"):
        tiny_test(moe_experts=4, moe_router="switch")
    with pytest.raises(ValueError, match="moe_dispatch='ring'"):
        tiny_test(moe_experts=4, moe_dispatch="ring")
    ec = GPTLM(tiny_test(moe_experts=4, moe_router="expert_choice"), device="cpu")
    with pytest.raises(NotImplementedError, match="expert-choice routing"):
        generate(ec, torch.zeros(1, 3, dtype=torch.long), max_new_tokens=2)
    with pytest.raises(NotImplementedError, match="interleaved pipeline schedule"):
        GPTLM(tiny_test(moe_experts=4, pipe_size=2, pipe_interleave=2), device="cpu")
    with pytest.raises(NotImplementedError, match="MoE under 1F1B"):
        make_gpt_1f1b_grad_fn(tiny_test(moe_experts=4, pipe_size=2))


def test_cli_trains_gpt2_moe_ep_under_torchrun():
    """``python -m tpu_parallel_torch.train --config=gpt2_moe_ep`` under
    torchrun (2 gloo CPU ranks on a model axis of 2, the model swapped for
    ``tiny``): exit 0, a falling logged loss and ``moe_balance`` logged."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=2",
         "-m", "tpu_parallel_torch.train", "--config=gpt2_moe_ep", "--config.model=tiny",
         "--config.mesh.model=2", "--config.global_batch_size=8", "--config.steps=6",
         "--config.log_every=3", "--config.warmup_steps=1", "--device=cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr[-3000:]
    assert '"process_count": 2' in out.stdout
    losses = [float(x) for x in re.findall(r"^step \d+: .*?loss=([0-9.]+)", out.stdout,
                                            re.MULTILINE)]
    assert len(losses) == 2 and losses[-1] < losses[0], out.stdout
    assert "moe_balance=" in out.stdout, out.stdout
