"""Port parity: FSDP (``parallel/fsdp.py``, ``parallel/spmd.py``,
``parallel/tp.py:export_single_device_params``, sharded ``TrainState``,
sharded checkpoints, ``Trainer`` with ``fsdp=True`` over a data mesh)
against the JAX package.

The multi-rank cases run once, in one 4-rank gloo group of CPU processes
(``tests/torch_dp_worker.py``, suite ``fsdp``), from JAX's own FSDP inits
(exported to one device and bridged) and numpy inputs, and are held to JAX
on ``MeshConfig(data=4)`` over four of the suite's simulated devices.
Tolerances (fp32), as the JAX tests state them: the MLP's params rtol 1e-4,
atol 1e-5 and its loss rel 1e-4 (``tests/test_fsdp.py``); FSDP against
replicated and chunked against unchunked, the first loss rtol 2e-5 and the
last 2e-4 (``tests/test_gpt.py``); the Trainer's losses rtol 1e-5 and its
gathered masters rtol 1e-4, atol 1e-5, the key slice of the qkv bias left
out (its gradient is rounding noise that AdamW normalizes; ROADMAP §C).
"""

import functools
import os
import subprocess
import sys
from pathlib import Path

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch_dp_worker import NUM_RANKS, flat_tree, run_once

from tpu_parallel.core import compute as jax_compute
from tpu_parallel.core.losses import make_classification_loss as jax_classification_loss
from tpu_parallel.core.state import Batch as JBatch
from tpu_parallel.data import lm_batch as jax_lm_batch
from tpu_parallel.models import GPTLM as JGPTLM
from tpu_parallel.models import MLPClassifier as JMLP
from tpu_parallel.models import MLPConfig as JMLPConfig
from tpu_parallel.models import make_gpt_loss as jax_gpt_loss
from tpu_parallel.models import tiny_test as jax_tiny
from tpu_parallel.models.generate import generate as jax_generate
from tpu_parallel.parallel import fsdp as jfsdp
from tpu_parallel.parallel.spmd import build_train_functions as jax_build
from tpu_parallel.parallel.spmd import make_model_init as jax_model_init
from tpu_parallel.parallel.tp import export_single_device_params as jax_export
from tpu_parallel.runtime import MeshConfig as JMeshConfig
from tpu_parallel.runtime import make_mesh as jax_make_mesh
from tpu_parallel.train_lib import Trainer as JTrainer
from tpu_parallel.train_lib import TrainerConfig as JTrainerConfig
from tpu_parallel_torch.models import GPTLM, tiny_test
from tpu_parallel_torch.models.convert import _SCANNED, _TOP, _block_leaves, params_from_jax
from tpu_parallel_torch.parallel import fsdp
from tpu_parallel_torch.parallel.spmd import build_train_functions
from tpu_parallel_torch.train_lib import Trainer, TrainerConfig

# one torch intra-op thread per test process (pytest-xdist shares the cores)
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
MLP_IN = 32
FSDP_KW = dict(fsdp=True, fsdp_min_size=0)
TRAINER_KW = dict(model="tiny", global_batch_size=8, num_minibatches=2, steps=4,
                  warmup_steps=2)


def _mesh4():
    return jax_make_mesh(JMeshConfig(data=4), devices=jax.devices()[:NUM_RANKS])


def _paths(tree):
    """``{"a/b/c": leaf}`` of a flax tree, ``nn.Partitioned`` leaves kept."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, nn.Partitioned))[0]
    return {"/".join(k.key for k in path): leaf for path, leaf in flat}


def _port_leaves(path, cfg):
    """``[(port name, transposed, layer or None)]`` of one JAX leaf path."""
    if cfg is None:  # the MLP: hidden_{i}/kernel|bias and head/kernel|bias
        layer, leaf = path.split("/")
        return [(f"{layer}.{'weight' if leaf == 'kernel' else 'bias'}", leaf == "kernel", None)]
    for jpath, key, t in _TOP:
        if path == jpath:
            return [(key, t, None)]
    for jpath, key, t in _block_leaves(cfg):
        if path == _SCANNED + jpath:
            return [(f"blocks.layer_{i}.{key}", t, i) for i in range(cfg.n_layers)]
    raise KeyError(path)


def _jax_shards(params, mesh, cfg=None):
    """``{port name: (torch dim or None, [device r's slice, bridged])}`` of a
    JAX state's params: the dim ``shard_params`` chose, read off the
    ``nn.Partitioned`` names, and each device's data (scanned layers split,
    kernels transposed, the size-1 model axis of a ``shard/sharded`` scope
    squeezed)."""
    devices = list(mesh.devices.flat)
    out = {}
    for path, leaf in _paths(params).items():
        value = leaf.value if isinstance(leaf, nn.Partitioned) else leaf
        names = list(leaf.names) if isinstance(leaf, nn.Partitioned) else [None] * value.ndim
        by_device = {s.device: np.asarray(s.data) for s in value.addressable_shards}
        per_rank = [by_device[d] for d in devices]
        if "/sharded/" in path:  # a ModuleShard's stacked model axis, size 1 here
            path = path.replace("/sharded/", "/")
            axis = names.index("model")
            names.pop(axis)
            per_rank = [x.squeeze(axis) for x in per_rank]
        for name, transposed, layer in _port_leaves(path, cfg):
            dims, data = list(names), per_rank
            if layer is not None:
                dims, data = dims[1:], [x[layer] for x in data]
            if transposed:
                dims, data = dims[::-1], [x.T for x in data]
            out[name] = (dims.index("data") if "data" in dims else None, data)
    return out


# -- the JAX references, each computed once ----------------------------------


def _mlp_data():
    rng = np.random.default_rng(0)
    inputs = rng.standard_normal((128, MLP_IN)).astype(np.float32)
    labels = rng.integers(0, 10, 128).astype(np.int32)
    return inputs, labels


def _jax_mlp_model(min_size=0):
    wrapper = lambda cls: jfsdp.shard_module_params(cls, axis_name="data",
                                                    min_weight_size=min_size)
    return JMLP(JMLPConfig(hidden_size=64, num_classes=10, dropout_rate=0.0, dtype=jnp.float32),
                dense_wrapper=wrapper)


@functools.lru_cache(maxsize=None)
def _jax_mlp():
    """``tests/test_fsdp.py``'s FSDP MLP on data=4: its init (per-device
    shards and exported), and 3 steps on the first 64 rows."""
    inputs, labels = _mlp_data()
    batch = JBatch(inputs=jnp.asarray(inputs[:64]), labels=jnp.asarray(labels[:64]))
    funcs = jax_build(jax_model_init(_jax_mlp_model(), optax.adamw(1e-3)),
                      jax_classification_loss("data"), _mesh4(), batch, donate=False)
    state = funcs.init_fn(jax.random.PRNGKey(42), batch)
    init_shards = _jax_shards(state.params, _mesh4())
    mu_shards = _jax_shards(state.opt_state[0].mu, _mesh4())
    params0 = jax.tree.map(np.asarray, jax_export(state.params))
    losses = []
    for _ in range(3):
        state, metrics = funcs.step_fn(state, None, batch)
        losses.append(jax_compute(metrics)["loss"])
    return dict(params0=params0, init_shards=init_shards, mu_shards=mu_shards, losses=losses,
                params=jax.tree.map(np.asarray, jax_export(state.params)))


@functools.lru_cache(maxsize=None)
def _jax_gpt():
    """``tests/test_gpt.py``'s ``_train`` on data=4 (AdamW(3e-3), a batch of
    16): the FSDP init (per-device shards, exported), and each step's loss
    replicated, FSDP (8 steps) and FSDP with ``loss_chunk=16``."""
    mesh = _mesh4()
    out = {}
    for name, steps, overrides in (("dp", 4, {}), ("fsdp", 8, FSDP_KW),
                                   ("fsdp_chunk", 4, dict(FSDP_KW, loss_chunk=16))):
        cfg = jax_tiny(**overrides)
        batch = jax_lm_batch(jax.random.PRNGKey(0), 16, cfg.seq_len, cfg.vocab_size)
        model, tx = JGPTLM(cfg), optax.adamw(3e-3)

        def init(rng, b, model=model, tx=tx):
            from tpu_parallel.core.state import TrainState

            v = model.init({"params": rng}, b.tokens, positions=b.positions, train=False)
            return TrainState.create(apply_fn=model.apply, params=v["params"], tx=tx, rng=rng)

        funcs = jax_build(init, jax_gpt_loss(cfg), mesh, batch, batch_spec=P("data"),
                          donate=False)
        state = funcs.init_fn(jax.random.PRNGKey(42), batch)
        out[f"{name}_params0"] = jax.tree.map(np.asarray, jax_export(state.params))
        if name == "fsdp":
            out["fsdp_shards"] = _jax_shards(state.params, mesh, tiny_test())
            out["fsdp_specs"] = _paths(nn.get_partition_spec(state).params)
            out["batch"] = {k: np.asarray(v) for k, v in vars(batch).items() if v is not None}
        losses = []
        for _ in range(steps):
            state, metrics = funcs.step_fn(state, None, batch)
            losses.append(jax_compute(metrics)["loss"])
        out[f"{name}_losses"] = losses
    return out


@functools.lru_cache(maxsize=None)
def _jax_trainer(impl):
    """JAX's Trainer with ``fsdp=True`` on data=4: its init (exported), its
    example batch, and 4 steps' losses and exported masters."""
    trainer = JTrainer(JTrainerConfig(**TRAINER_KW, model_overrides=dict(attn_impl=impl,
                                                                          **FSDP_KW)),
                       mesh=_mesh4())
    state = trainer.init()
    params0 = jax.tree.map(np.asarray, jax_export(state.params))
    example = {k: np.asarray(v) for k, v in vars(trainer.example_batch).items() if v is not None}
    losses = []
    for _ in range(4):
        state, metrics = trainer.funcs.step_fn(state, None, trainer.example_batch)
        losses.append(jax_compute(metrics)["loss"])
    return params0, example, losses, jax.tree.map(np.asarray, jax_export(state.params))


@functools.lru_cache(maxsize=None)
def _jax_export_tokens():
    """``tests/test_generate.py``'s FSDP export case: greedy tokens of plain
    ``generate`` on the exported FSDP init (the one ``_jax_gpt`` makes)."""
    cfg = jax_tiny(dtype=jnp.float32, **FSDP_KW)
    params = jax.tree.map(jnp.asarray, _jax_gpt()["fsdp_params0"])
    return np.asarray(jax_generate(JGPTLM(cfg), params, jnp.zeros((1, 4), jnp.int32),
                                   max_new_tokens=4))


def _make_inputs(outdir):
    inputs, labels = _mlp_data()
    gpt = _jax_gpt()
    params0, example, _, _ = _jax_trainer("xla")
    return {**flat_tree("mlp", _jax_mlp()["params0"]), "mlp_inputs": inputs,
            "mlp_labels": labels, **flat_tree("gparams", gpt["fsdp_params0"]),
            **flat_tree("gbatch", gpt["batch"]), **flat_tree("tparams", params0),
            **flat_tree("example", example)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_once("fsdp", tmp_path_factory, _make_inputs)


def _leaves(out, prefix):
    return {k[len(prefix) + 1:]: v for k, v in out.items() if k.startswith(prefix + "/")}


def _not_key(cfg):
    dh = cfg.head_dim
    return ((np.arange(3 * cfg.d_model) % (3 * dh)) // dh) != 1


# -- one process --------------------------------------------------------------


@pytest.mark.parametrize("size", [2, 4])
def test_shard_dim_is_jax_rule_at_gpt2_widths(size):
    """``shard_dim`` picks the dim JAX's ``shard_params`` picks, for every
    leaf shape of GPT-2 125M at the default minimum size (flax kernels are
    the transpose of the port's ``Linear`` weights; of two equal dims the
    later one)."""
    shapes = {"qkv": (768, 2304), "out": (768, 768), "up": (768, 3072), "down": (3072, 768),
              "lm_head": (768, 50304), "tok": (50304, 768), "pos": (1024, 768),
              "qkv_bias": (2304,), "bias": (768,), "mlp_bias": (3072,), "odd": (769, 5)}
    kernels = {"qkv", "out", "up", "down", "lm_head", "odd"}
    mesh = jax_make_mesh(JMeshConfig(data=size), devices=jax.devices()[:size])
    tree = {k: jax.ShapeDtypeStruct(v, jnp.float32) for k, v in shapes.items()}
    probe = jax.shard_map(lambda p: jfsdp.shard_params(p, "data"), mesh=mesh, in_specs=P(),
                          out_specs=P(), check_vma=False)
    specs = nn.get_partition_spec(jax.eval_shape(probe, tree))
    for key, shape in shapes.items():
        names = list(specs[key]) + [None] * (len(shape) - len(specs[key]))
        want = names.index("data") if "data" in names else None
        transposed = key in kernels
        torch_shape = shape[::-1] if transposed else shape
        if transposed and want is not None:
            want = len(shape) - 1 - want
        assert fsdp.shard_dim(torch_shape, size, fsdp.DEFAULT_MIN_WEIGHT_SIZE,
                              transposed) == want, key


def test_fsdp_config_without_mesh_is_replicated():
    """An ``fsdp=True`` config on one device (no mesh) holds full weights
    and trains bitwise as ``fsdp=False`` does (JAX's unbound-axis rule)."""
    runs, before = [], fsdp.fsdp_allgather_launches
    for overrides in ({}, FSDP_KW):
        trainer = Trainer(TrainerConfig(model="tiny", global_batch_size=4, steps=2,
                                        warmup_steps=1, model_overrides=overrides),
                          device="cpu")
        state = trainer.init()
        assert not state.shards
        trainer.train(steps=2)
        runs.append(trainer)
    assert fsdp.fsdp_allgather_launches == before
    a, b = runs
    assert a.num_params == b.num_params
    for name, p in a.state.params.items():
        assert torch.equal(p, b.state.params[name]), name


def test_spmd_refuses_what_it_does_not_port():
    """``build_train_functions`` takes a schedule-owned ``grad_fn`` (the
    1F1B pipeline) but refuses it with ``num_minibatches > 1`` in JAX's
    words; it takes every mesh axis: a model axis above 1 is tensor
    parallelism (``tests/test_torch_tp.py``), a pipe axis pipeline
    parallelism (``tests/test_torch_pp.py``) and a seq axis sequence
    parallelism, its gradients synced over ``("data", "seq", "model")``
    (``tests/test_torch_sp.py``); without a mesh those axes are unbound
    and the sync is the identity."""
    from tpu_parallel_torch.core.optim import AdamW
    from tpu_parallel_torch.parallel import spmd
    from tpu_parallel_torch.parallel.spmd import make_model_init

    model = GPTLM(tiny_test(), device="cpu")
    init = make_model_init(model, AdamW(lambda count: 1e-3))
    build_train_functions(init, None, None, grad_fn=lambda *a: None)
    with pytest.raises(ValueError, match="does not compose with a schedule-owned grad_fn"):
        build_train_functions(init, None, None, grad_fn=lambda *a: None, num_minibatches=2)
    assert not hasattr(spmd, "refuse_later_axes") and not hasattr(spmd, "_LATER_AXES")
    build_train_functions(init, None, None, grad_sync_axes=("data", "seq", "model"))
    funcs = build_train_functions(init, None, None)
    assert funcs.state_specs["lm_head.weight"] == (None, None)
    assert funcs.state_shapes["lm_head.weight"] == (256, 32)


# -- the 4-rank group ------------------------------------------------------------


def test_mlp_params_are_sharded(ranks):
    """``tests/test_fsdp.py::test_params_are_sharded`` on data=4: each rank's
    slice has JAX's per-device shape through the bridge and equals JAX's
    slice at its coordinate; AdamW's moments are sharded alike; the head's
    bias (10 rows, not divisible by 4) stays replicated."""
    import json

    want = _jax_mlp()
    for r, out in enumerate(ranks):
        for name, (dim, data) in want["init_shards"].items():
            assert tuple(out[f"mlp_shape/{name}"]) == data[r].shape, name
            np.testing.assert_array_equal(out[f"mlp_init/{name}"], data[r], err_msg=name)
            assert tuple(out[f"mlp_mu_shape/{name}"]) == want["mu_shards"][name][1][r].shape
            spec = json.loads(str(out[f"mlp_spec/{name}"]))
            assert (spec.index("data") if "data" in spec else None) == dim, name
    assert want["init_shards"]["hidden_0.weight"][0] == 0
    assert want["init_shards"]["head.bias"][0] is None


def test_mlp_fsdp_loss_decreases(ranks):
    """``test_fsdp_loss_decreases``: 16 steps of 4 minibatches."""
    for out in ranks:
        losses = out["mlp_decrease_losses"]
        assert losses[-1] < losses[0]


def test_mlp_fsdp_matches_dp_and_jax(ranks):
    """``test_fsdp_matches_dp``: after 3 steps the gathered FSDP masters
    equal replicated DP's (rtol 1e-4, atol 1e-5) and the losses agree (rel
    1e-4); both equal JAX's FSDP run."""
    from tpu_parallel_torch.models.mlp import MLPConfig

    want = _jax_mlp()
    cfg = MLPConfig(hidden_size=64, num_classes=10, dtype=torch.float32)
    jax_params = params_from_jax(want["params"], cfg, dtype=torch.float32)
    for out in ranks:
        got, dp_params = _leaves(out, "mlp_fsdp"), _leaves(out, "mlp_dp")
        assert got.keys() == dp_params.keys() == jax_params.keys()
        for name, value in got.items():
            np.testing.assert_allclose(value, dp_params[name], rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(value, jax_params[name].numpy(), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(out["mlp_fsdp_losses"], out["mlp_dp_losses"], rtol=1e-4)
        np.testing.assert_allclose(out["mlp_fsdp_losses"], want["losses"], rtol=1e-4)


def test_min_weight_size_keeps_small_params_replicated(ranks):
    for out in ranks:
        assert int(out["mlp_min_size_shards"]) == 0


def test_sync_gradients_partition_aware(ranks):
    """Sharded leaves keep their per-rank values 0..3; a replicated leaf
    gets their mean, 1.5.  On a data=2 x model=2 mesh, ``axis_names``
    (data, model) and ``psum_axes`` (model): a replicated leaf 1 + data +
    model is averaged over both axes (2) and then summed over model (4); a
    leaf 1 + model sharded on model is averaged over data only, and
    divided by the model size, an axis of ``replicated_loss_axes`` that
    ``axis_names`` holds (JAX's ``sync_gradients``)."""
    for r, out in enumerate(ranks):
        np.testing.assert_array_equal(out["sync_sharded"], np.arange(4.0))
        np.testing.assert_array_equal(out["sync_replicated"], [1.5])
        model = r % 2
        np.testing.assert_array_equal(out["sync22_replicated"], [4.0])
        np.testing.assert_array_equal(out["sync22_model_sharded"], [(1.0 + model) / 2])


def test_shard_params_and_gather_params(ranks):
    """``shard_params`` slices a ``Linear`` weight [64, 32] (flax's kernel
    [32, 64]: JAX splits its 64) into each rank's 16 rows as a ``DTensor``
    and keeps a bias of 10 (not divisible by 4) replicated;
    ``gather_params`` gives the full tensors back."""
    full = np.arange(64 * 32, dtype=np.float32).reshape(64, 32)
    for r, out in enumerate(ranks):
        np.testing.assert_array_equal(out["shard_params_kernel"], full[16 * r:16 * r + 16])
        assert not bool(out["shard_params_bias_is_dtensor"])
        assert bool(out["gather_params_equal"])


def test_gpt_fsdp_training(ranks):
    """``test_gpt_fsdp_training``: the qkv, mlp and lm_head weights are
    sharded over data (each rank's slice JAX's, through the bridge), and the
    loss falls over 8 steps."""
    import json

    want = _jax_gpt()
    specs = want["fsdp_specs"]
    for sub in ("qkv", "mlp", "lm_head"):
        hits = [s for p, s in specs.items() if sub in p and p.endswith("kernel")]
        assert hits and all("data" in str(s) for s in hits), sub
    for r, out in enumerate(ranks):
        port_specs = json.loads(str(out["gpt_fsdp_specs"]))
        for name in ("blocks.layer_0.attn.qkv.weight", "blocks.layer_3.mlp.down.weight",
                     "lm_head.weight", "embed.tok.weight"):
            assert "data" in port_specs[name], name
        for name, (dim, data) in want["fsdp_shards"].items():
            spec = port_specs[name]
            assert (spec.index("data") if "data" in spec else None) == dim, name
            np.testing.assert_array_equal(out[f"gpt_fsdp_init/{name}"], data[r], err_msg=name)
        losses = out["gpt_fsdp_losses"]
        assert losses[-1] < losses[0]


def test_gpt_fsdp_gradients_match_one_process(ranks):
    """The synced FSDP gradients (each rank's slices reduce-scattered and
    divided by the axis size, accumulated over 2 minibatches), gathered,
    equal one process's gradient on the whole batch within 1e-5 of each
    leaf's largest value: the scale AdamW's normalization would hide."""
    for out in ranks:
        got, want = _leaves(out, "grad_fsdp"), _leaves(out, "grad_single")
        assert got.keys() == want.keys() and got
        for name, w in want.items():
            assert np.abs(got[name] - w).max() <= 1e-5 * np.abs(w).max() + 1e-12, name


def test_gpt_fsdp_matches_replicated(ranks):
    """``test_gpt_fsdp_matches_replicated``: the same init and batch give
    the replicated trajectory (first loss rtol 2e-5, fourth 2e-4), and both
    equal JAX's on data=4."""
    want = _jax_gpt()
    for out in ranks:
        fs, rep = out["gpt_fsdp_losses"][:4], out["gpt_dp_losses"]
        np.testing.assert_allclose(fs[0], rep[0], rtol=2e-5)
        np.testing.assert_allclose(fs[3], rep[3], rtol=2e-4)
        np.testing.assert_allclose(out["gpt_fsdp_losses"], want["fsdp_losses"], rtol=2e-5)
        np.testing.assert_allclose(rep, want["dp_losses"], rtol=2e-5)


def test_gpt_fsdp_chunked_loss_matches_unchunked(ranks):
    """``test_gpt_fsdp_chunked_loss_matches_unchunked``: the lm_head
    gathered once for all chunks gives the unchunked trajectory."""
    want = _jax_gpt()
    for out in ranks:
        chunk, whole = out["gpt_fsdp_chunk_losses"], out["gpt_fsdp_losses"][:4]
        np.testing.assert_allclose(chunk[0], whole[0], rtol=2e-5)
        np.testing.assert_allclose(chunk[3], whole[3], rtol=2e-4)
        np.testing.assert_allclose(chunk, want["fsdp_chunk_losses"], rtol=2e-5)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_trainer_fsdp_matches_jax(ranks, impl):
    """``Trainer`` with ``fsdp=True`` on ``tiny`` over data=4 against JAX's
    Trainer: 4 steps from the same init on JAX's example batch, losses
    within 1e-5 relative, gathered masters within ``test_fsdp_matches_dp``'s
    rtol 1e-4 / atol 1e-5 (the qkv bias's key slice left out); the gathered
    masters and the replicated leaves equal on every rank (flash: the
    port's plain versions against JAX's interpret-mode kernels)."""
    _, _, want_losses, want_params = _jax_trainer(impl)
    cfg = tiny_test()
    want = params_from_jax(want_params, cfg, dtype=torch.float32)
    for out in ranks:
        np.testing.assert_allclose(out[f"trainer_{impl}_losses"], want_losses, rtol=1e-5)
        got = _leaves(out, f"trainer_{impl}")
        assert got.keys() == want.keys()
        for name, w in want.items():
            g, w = got[name], w.numpy()
            if name.endswith("attn.qkv.bias"):
                g, w = g[_not_key(cfg)], w[_not_key(cfg)]
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5, err_msg=name)
        assert out[f"trainer_{impl}_replicated"].tolist() == ["norm_final.bias",
                                                              "norm_final.weight"]
    for out in ranks[1:]:
        for prefix in (f"trainer_{impl}", f"trainer_{impl}_rep"):
            for name, value in _leaves(out, prefix).items():
                np.testing.assert_array_equal(value, ranks[0][f"{prefix}/{name}"])


def test_fsdp_collectives_per_step(ranks):
    """Per step of ``tiny`` (4 layers, remat) in 2 minibatches: each block
    gathers twice per minibatch (forward and the backward's recompute), the
    embedding and the lm_head once; the backward reduce-scatters once per
    gather it differentiates; the replicated leaves take one all-reduce."""
    layers, minibatches = tiny_test().n_layers, 2
    want = [minibatches * (2 * layers + 2), minibatches * (layers + 2), 1]
    for out in ranks:
        for impl in ("xla", "flash"):
            assert out[f"trainer_{impl}_counts"].tolist() == [want] * 4


def test_export_fsdp_sharded_params_and_generate(ranks):
    """``test_export_fsdp_sharded_params_and_generate``: the exported FSDP
    init serves plain ``generate`` with JAX's greedy tokens, its logits
    equal the mesh model's on the same tokens, and its serving weight set's
    fingerprint equals that of the replicated weights.  A leaf split over
    the model axis is refused with JAX's ``ValueError`` (serve it under the
    mesh)."""
    tokens = _jax_export_tokens()
    for out in ranks:
        np.testing.assert_array_equal(out["export_tokens"], tokens)
        np.testing.assert_allclose(out["export_mesh_logits"], out["export_single_logits"],
                                   rtol=1e-5, atol=1e-5)
        assert str(out["export_fingerprint"]) == str(out["export_dp_fingerprint"])
        assert "run inference under the mesh" in str(out["export_model_split_error"])


def test_checkpoint_roundtrip_sharded(ranks):
    """The FSDP part of ``test_checkpoint_roundtrip_sharded``: every rank's
    shards restore bitwise into a fresh Trainer, which trains on as the
    saved one does.  A checkpoint without EMA restores into an EMA trainer
    with a warning, the shadow seeded from the restored masters; ``fit``
    resumes at its last save and keeps ``max_to_keep`` step directories."""
    for out in ranks:
        assert int(out["ckpt_step"]) == 3
        assert ".metadata" in out["ckpt_files"].tolist()
        assert bool(out["ckpt_bitwise"]) and bool(out["ckpt_module_bitwise"])
        a, b = out["ckpt_more_losses"]
        assert a == b and a > 0
        assert bool(out["ckpt_ema_drift_warned"]) and bool(out["ckpt_ema_seeded_local"])
        assert out["fit_steps_seen"].tolist() == [0, 1, 2, 3, 4, 5]
        assert out["fit_dirs"].tolist() == ["5", "6"]


def test_cli_overrides_fsdp_and_no_other_model_field():
    """``--config.model_overrides.fsdp`` and ``fsdp_min_size`` are accepted
    on ``gpt2_125m_dp`` (which does not declare them), typed; any other
    undeclared model field stays a ``KeyError``."""
    from tpu_parallel_torch.configs import get_config, override

    config = get_config("gpt2_125m_dp")
    override(config, "model_overrides.fsdp", "True")
    override(config, "model_overrides.fsdp_min_size", "0")
    assert config["model_overrides"]["fsdp"] is True
    assert config["model_overrides"]["fsdp_min_size"] == 0
    for field in ("mlp_ratio", "dense_bias", "moe_experts"):
        with pytest.raises(KeyError):
            override(config, f"model_overrides.{field}", "1")
    with pytest.raises(KeyError):
        override(config, "fsdp", "True")


def test_cli_trains_fsdp_under_torchrun():
    """``python -m tpu_parallel_torch.train --config=gpt2_125m_dp
    --config.model_overrides.fsdp=True`` under torchrun (2 gloo CPU ranks,
    the model swapped for ``tiny``): exit 0, a falling logged loss."""
    import re

    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=2",
         "-m", "tpu_parallel_torch.train", "--config=gpt2_125m_dp", "--config.model=tiny",
         "--config.model_overrides.fsdp=True", "--config.model_overrides.fsdp_min_size=0",
         "--config.global_batch_size=8", "--config.steps=6", "--config.log_every=3",
         "--config.warmup_steps=1", "--device=cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr[-3000:]
    assert '"process_count": 2' in out.stdout and '"backend": "gloo"' in out.stdout
    losses = [float(x) for x in re.findall(r"^step \d+: .*?loss=([0-9.]+)", out.stdout,
                                            re.MULTILINE)]
    assert len(losses) == 2 and losses[-1] < losses[0], out.stdout


@pytest.fixture
def world_of_one(tmp_path):
    """A gloo group of one in this process and its data mesh: real
    collectives, each shard the whole tensor."""
    import torch.distributed as dist

    from tpu_parallel_torch.runtime import MeshConfig, make_mesh

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rendezvous'}",
                            world_size=1, rank=0)
    try:
        yield make_mesh(MeshConfig(data=1))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("policy", ["full", "proj", "proj_attn", "dots"])
def test_remat_regathers_and_saves_no_gathered_weight(world_of_one, policy):
    """Under every remat policy the block's gather runs inside the
    checkpointed call: no gathered block weight is alive between the
    forward and the backward (no policy saved one), the backward gathers
    each block again and reduce-scatters once per block, and the fp32
    gradients equal the unsharded model's bitwise (a world of one)."""
    import gc
    import weakref

    from tpu_parallel_torch.models.gpt import make_gpt_loss

    cfg = tiny_test(remat_policy=policy, attn_impl="flash", **FSDP_KW)
    plain = GPTLM(tiny_test(remat_policy=policy, attn_impl="flash"), device="cpu")
    model = GPTLM(cfg, device="cpu", mesh=world_of_one)
    model.load_state_dict(plain.state_dict())
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, 256, (2, 33)))
    from tpu_parallel_torch.core.state import TextBatch

    batch = TextBatch(tokens=tokens[:, :-1], targets=tokens[:, 1:])
    block_shapes = {tuple(p.shape) for p in plain.blocks.layer_0.parameters()}
    gathered = []
    real = fsdp._gather

    def watched(infos, shards):
        fulls = real(infos, shards)
        gathered.extend(weakref.ref(t) for t in fulls if tuple(t.shape) in block_shapes)
        return fulls

    fsdp._gather = watched
    try:
        before = fsdp.fsdp_allgather_launches, fsdp.fsdp_reducescatter_launches
        loss, _ = make_gpt_loss(cfg)(model, batch)
        gc.collect()
        alive = sum(ref() is not None for ref in gathered)
        forward_gathers = fsdp.fsdp_allgather_launches - before[0]
        loss.backward()
    finally:
        fsdp._gather = real
    assert alive == 0 and len(gathered) >= len(list(model.blocks.layer_0.parameters())) * 4
    n = cfg.n_layers
    assert forward_gathers == n + 2
    assert fsdp.fsdp_allgather_launches - before[0] == 2 * n + 2
    assert fsdp.fsdp_reducescatter_launches - before[1] == n + 2
    want, _ = make_gpt_loss(cfg)(plain, batch)
    want.backward()
    assert loss.item() == want.item()
    for (name, p), q in zip(model.named_parameters(), plain.parameters()):
        assert torch.equal(p.main_grad if hasattr(p, "main_grad") else p.grad, q.grad), name


def test_host_snapshot_mesh_is_a_cpu_twin(world_of_one):
    """A sharded save's host snapshot is placed on a CPU twin of the state's
    mesh (same ranks, axis names, coordinate and groups): a ``DTensor``
    over a ``"cuda"`` mesh would move its pinned local tensor back onto the
    card.  A CPU mesh is its own twin."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from tpu_parallel_torch.checkpoint.io import _host_mesh

    mesh = world_of_one
    assert _host_mesh(mesh) is mesh
    # a "cuda" mesh over the same groups (no card needed to describe one)
    card = DeviceMesh.from_group([mesh.get_group(i) for i in range(mesh.ndim)], "cuda",
                                 mesh.mesh, mesh_dim_names=mesh.mesh_dim_names)
    host = _host_mesh(card)
    assert host.device_type == "cpu" and _host_mesh(card) is host
    assert torch.equal(host.mesh, card.mesh) and host.mesh_dim_names == card.mesh_dim_names
    assert host.get_coordinate() == card.get_coordinate()
    assert [host.get_group(i) for i in range(host.ndim)] == \
        [card.get_group(i) for i in range(card.ndim)]
    local = torch.arange(6.0).reshape(2, 3)
    view = DTensor.from_local(local, host, [Shard(0)] + [Replicate()] * (host.ndim - 1),
                              run_check=False)
    assert view.to_local().data_ptr() == local.data_ptr()
