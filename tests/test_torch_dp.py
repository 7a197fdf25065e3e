"""Port parity: data parallelism (``parallel/dp.py``, ``models/mlp.py``,
``make_classification_loss``, the rank-aware ``DataLoader`` and
``make_global_batch``, and ``Trainer`` / ``fit`` / the CLI over a data
mesh) against the JAX package.

The multi-rank cases run once, in one 4-rank gloo group of CPU processes
(``tests/torch_dp_worker.py``, suite ``dp``), from bridged JAX weights and
numpy inputs, and are held to JAX on ``MeshConfig(data=4)`` over four of
the suite's simulated devices.  Tolerances (fp32): the MLP step's params
rtol 1e-4, atol 1e-5 and its loss rel 1e-4 (``tests/test_dp.py:60-88``'s);
the Trainer's losses rtol 1e-5 and its masters a relative L2 error of 3e-5
per weight, the key slice of the qkv bias left out
(``tests/test_torch_train.py``'s, for the same reasons).  Replicas must be
bitwise equal across ranks.
"""

import functools
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_dp_worker import NUM_RANKS, flat_tree, nested_tree, run_once

from tpu_parallel.core import TrainState as JTrainState
from tpu_parallel.core import compute as jax_compute
from tpu_parallel.core.losses import make_classification_loss as jax_classification_loss
from tpu_parallel.core.state import Batch as JBatch
from tpu_parallel.core.state import TextBatch as JTextBatch
from tpu_parallel.models import MLPClassifier as JMLP
from tpu_parallel.models import MLPConfig as JMLPConfig
from tpu_parallel.parallel import dp as jdp
from tpu_parallel.parallel.tp import export_single_device_params
from tpu_parallel.runtime import MeshConfig as JMeshConfig
from tpu_parallel.runtime import make_mesh as jax_make_mesh
from tpu_parallel.train_lib import Trainer as JTrainer
from tpu_parallel.train_lib import TrainerConfig as JTrainerConfig
from tpu_parallel_torch.core.losses import make_classification_loss
from tpu_parallel_torch.core.metrics import compute
from tpu_parallel_torch.core.optim import AdamW
from tpu_parallel_torch.core.state import Batch, TextBatch, TrainState
from tpu_parallel_torch.data import PackedDataset, TokenDataset
from tpu_parallel_torch.models.convert import params_from_jax, params_to_jax
from tpu_parallel_torch.models.mlp import MLPClassifier, MLPConfig
from tpu_parallel_torch.parallel import dp
from tpu_parallel_torch.train_lib import Trainer, TrainerConfig

# one torch intra-op thread per test process (pytest-xdist shares the cores)
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
MLP_IN, MLP_BATCH, MLP_STEPS = 32, 128, 3
TRAINER_KW = dict(model="tiny", global_batch_size=8, num_minibatches=2, steps=3,
                  warmup_steps=2)
TOL = 1e-5


def _mesh4():
    return jax_make_mesh(JMeshConfig(data=4), devices=jax.devices()[:NUM_RANKS])


@functools.lru_cache(maxsize=None)
def _mlp_inputs():
    """The JAX MLP's init (fp32, dropout 0) and a numpy batch of 128."""
    rng = np.random.default_rng(0)
    inputs = rng.standard_normal((MLP_BATCH, MLP_IN)).astype(np.float32)
    labels = rng.integers(0, 10, MLP_BATCH).astype(np.int32)
    model = JMLP(JMLPConfig(hidden_size=64, num_classes=10, dropout_rate=0.0, dtype=jnp.float32))
    params = model.init({"params": jax.random.PRNGKey(1)}, jnp.zeros((1, MLP_IN)),
                        train=False)["params"]
    return jax.tree.map(np.asarray, params), inputs, labels


@functools.lru_cache(maxsize=None)
def _trainer_inputs():
    """The JAX Trainer's init on data=4 (exported to one device) and its
    global example batch, and a packed batch of 8 rows of 32 whose ranks'
    blocks count different tokens."""
    trainer = JTrainer(JTrainerConfig(**TRAINER_KW), mesh=_mesh4())
    params0 = jax.tree.map(np.asarray, export_single_device_params(trainer.init().params))
    example = {k: np.asarray(v) for k, v in vars(trainer.example_batch).items() if v is not None}
    rng = np.random.default_rng(3)
    docs = [np.append(rng.integers(4, 200, int(rng.integers(2, 40))), 3) for _ in range(80)]
    ds = PackedDataset(np.concatenate(docs).astype(np.uint16), 32, eos_id=3)
    b = ds.batch(np.arange(8))
    packed = dict(tokens=b.tokens, targets=b.targets, loss_mask=b.loss_mask,
                  segment_ids=b.segment_ids, positions=b.positions)
    return params0, example, packed


def _corpus():
    return np.random.default_rng(0).integers(0, 256, size=4000, dtype=np.uint16)


def _make_inputs(outdir):
    TokenDataset.write_bin(str(outdir / "corpus.bin"), _corpus())
    params, inputs, labels = _mlp_inputs()
    params0, example, packed = _trainer_inputs()
    return {**flat_tree("mlp", params), "mlp_inputs": inputs, "mlp_labels": labels,
            **flat_tree("tparams", params0), **flat_tree("example", example),
            **flat_tree("packed", packed)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_once("dp", tmp_path_factory, _make_inputs)


def _leaves(out, prefix):
    return {k[len(prefix) + 1:]: v for k, v in out.items() if k.startswith(prefix + "/")}


def _assert_replicas_equal(ranks, prefix):
    for out in ranks[1:]:
        got = _leaves(out, prefix)
        assert got.keys() == _leaves(ranks[0], prefix).keys() and got
        for name, value in got.items():
            np.testing.assert_array_equal(value, ranks[0][f"{prefix}/{name}"], err_msg=name)


@functools.lru_cache(maxsize=None)
def _jax_mlp_dp():
    """``tests/test_dp.py``'s DP step on data=4: AdamW(1e-3), 2 minibatches."""
    params, inputs, labels = _mlp_inputs()
    model = JMLP(JMLPConfig(hidden_size=64, num_classes=10, dropout_rate=0.0, dtype=jnp.float32))
    tx = optax.adamw(1e-3)
    mesh = _mesh4()

    def init(rng, batch_inputs):
        return JTrainState.create(apply_fn=model.apply, params=jax.tree.map(jnp.asarray, params),
                                  tx=tx, rng=rng)

    state = jdp.make_init(init, mesh=mesh)(jax.random.PRNGKey(42), jnp.asarray(inputs))
    step = jdp.make_train_step(jax_classification_loss("data"), num_minibatches=2, mesh=mesh,
                               donate=False)
    batch = JBatch(inputs=jnp.asarray(inputs), labels=jnp.asarray(labels))
    losses = []
    for _ in range(MLP_STEPS):
        state, metrics = step(state, None, batch)
        losses.append(jax_compute(metrics)["loss"])
    return jax.tree.map(np.asarray, state.params), losses, float(metrics["loss"][1])


def _mlp_pair(dtype, rate=0.0):
    """The JAX MLP (``dtype``) with its init and the port's on the same
    weights."""
    params, inputs, labels = _mlp_inputs()
    jcfg = JMLPConfig(hidden_size=64, num_classes=10, dropout_rate=rate,
                      dtype=getattr(jnp, dtype))
    cfg = MLPConfig(hidden_size=64, num_classes=10, dropout_rate=rate,
                    dtype=getattr(torch, dtype))
    model = MLPClassifier(cfg, MLP_IN, device="cpu")
    model.load_state_dict(params_from_jax(params, cfg))
    return JMLP(jcfg), params, model, cfg, inputs, labels


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_forward_loss_and_grads_match_jax(dtype):
    """Logits, the classification loss and its metrics, and (fp32) the
    gradients equal JAX's on bridged weights: fp32 within 1e-5 of the
    largest value; bf16 logits within 2e-2 of it (both round activations
    and weights to bf16, in other orders)."""
    jm, params, model, cfg, inputs, labels = _mlp_pair(dtype)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(inputs), train=False))
    with torch.no_grad():
        got = model(torch.from_numpy(inputs)).numpy()
    assert got.dtype == np.float32
    tol = 1e-5 if dtype == "float32" else 2e-2
    assert np.abs(got - want).max() <= tol * np.abs(want).max()
    jbatch = JBatch(inputs=jnp.asarray(inputs), labels=jnp.asarray(labels))
    (jloss, jmetrics), jgrads = jax.value_and_grad(jax_classification_loss("data"), has_aux=True)(
        jax.tree.map(jnp.asarray, params), jm.apply, jbatch, jax.random.PRNGKey(0))
    loss, metrics = make_classification_loss("data")(
        model, Batch(inputs=torch.from_numpy(inputs), labels=torch.from_numpy(labels).long()),
        torch.Generator())
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=tol)
    want_metrics = jax_compute(jmetrics)
    got_metrics = compute({k: (s.detach(), c) for k, (s, c) in metrics.items()})
    assert float(metrics["loss"][1]) == MLP_BATCH
    np.testing.assert_allclose(got_metrics["loss"], want_metrics["loss"], rtol=tol)
    if dtype == "float32":
        assert got_metrics["accuracy"] == want_metrics["accuracy"]
        want_grads = params_from_jax(jax.tree.map(np.asarray, jgrads), cfg)
        for name, p in model.named_parameters():
            w = want_grads[name].numpy()
            assert np.abs(p.grad.numpy() - w).max() <= 1e-5 * np.abs(w).max(), name


def test_mlp_bridge_round_trip_and_refusals():
    """``params_to_jax`` inverts ``params_from_jax`` on the MLP tree; a
    missing or extra leaf or a wrong shape raises, as for the GPT tree."""
    params, _, _ = _mlp_inputs()
    cfg = MLPConfig(hidden_size=64, num_classes=10, dtype=torch.float32)
    back = params_to_jax(params_from_jax(params, cfg), cfg)
    assert flat_tree("p", back).keys() == flat_tree("p", params).keys()
    for key, value in flat_tree("p", params).items():
        np.testing.assert_array_equal(flat_tree("p", back)[key], value, err_msg=key)
    missing = {k: v for k, v in params.items() if k != "head"}
    with pytest.raises(KeyError, match="head"):
        params_from_jax(missing, cfg)
    with pytest.raises(ValueError, match="extra"):
        params_from_jax({**params, "extra": {"kernel": np.zeros((2, 2))}}, cfg)
    wrong = {**params, "head": {"kernel": np.zeros((64, 7), np.float32),
                                "bias": np.zeros(7, np.float32)}}
    with pytest.raises(ValueError, match="head"):
        params_from_jax(wrong, cfg)
    with pytest.raises(KeyError):
        params_to_jax({"head.weight": torch.zeros(10, 64)}, cfg)


def test_mlp_dropout_and_classification_batch():
    """Dropout in training needs a generator, repeats for a seed and
    differs across seeds; evaluation is the plain forward.
    ``classification_batch`` draws [batch, input] normals and labels in
    range from its generator."""
    from tpu_parallel_torch.data import classification_batch

    _, _, model, cfg, inputs, _ = _mlp_pair("float32", rate=0.5)
    x = torch.from_numpy(inputs)
    with torch.no_grad():
        plain = model(x)
        with pytest.raises(ValueError, match="rng"):
            model(x, train=True)
        one = model(x, train=True, rng=torch.Generator().manual_seed(1))
        assert torch.equal(one, model(x, train=True, rng=torch.Generator().manual_seed(1)))
        assert not torch.equal(one, model(x, train=True, rng=torch.Generator().manual_seed(2)))
        assert not torch.equal(one, plain) and torch.equal(model(x, train=False), plain)
    batch = classification_batch(torch.Generator().manual_seed(0), 16, MLP_IN, 10)
    again = classification_batch(torch.Generator().manual_seed(0), 16, MLP_IN, 10)
    assert batch.inputs.shape == (16, MLP_IN) and batch.labels.shape == (16,)
    assert batch.size == 16 and batch.rows(4, 8).inputs.shape == (4, MLP_IN)
    assert int(batch.labels.min()) >= 0 and int(batch.labels.max()) < 10
    assert torch.equal(batch.inputs, again.inputs) and torch.equal(batch.labels, again.labels)


def test_mlp_dp_step_matches_jax(ranks):
    """Three DP steps of the MLP on 4 ranks against JAX's
    ``dp.make_train_step`` on data=4: params and losses within
    ``tests/test_dp.py``'s tolerances; the metric count is the global 128."""
    want_params, want_losses, want_count = _jax_mlp_dp()
    cfg = MLPConfig(hidden_size=64, num_classes=10, dropout_rate=0.0, dtype=torch.float32)
    want = params_from_jax(want_params, cfg, dtype=torch.float32)
    for out in ranks:
        for name, w in want.items():
            np.testing.assert_allclose(out[f"mlp_params/{name}"], w.numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=name)
        np.testing.assert_allclose(out["mlp_losses"], want_losses, rtol=1e-4)
        assert float(out["mlp_count"]) == want_count == MLP_BATCH
        assert int(out["mlp_allreduces"]) == MLP_STEPS


def test_mlp_dp_replicas_stay_bitwise_equal(ranks):
    """Masters and AdamW's first moments bitwise equal on every rank."""
    _assert_replicas_equal(ranks, "mlp_params")
    _assert_replicas_equal(ranks, "mlp_mu")


def test_mlp_dp_matches_single_rank(ranks):
    """DP on 4 ranks equals the port's one-process step on the whole batch
    (``tests/test_dp.py::test_dp_matches_single_device``)."""
    params, inputs, labels = _mlp_inputs()
    cfg = MLPConfig(hidden_size=64, num_classes=10, dropout_rate=0.0, dtype=torch.float32)
    model = MLPClassifier(cfg, MLP_IN, device="cpu")
    state = TrainState.create(model, AdamW(lambda count: 1e-3), torch.Generator(),
                              params_from_jax(params, cfg, dtype=torch.float32))
    step = dp.make_train_step(make_classification_loss("data"), num_minibatches=2)
    batch = Batch(inputs=torch.from_numpy(inputs), labels=torch.from_numpy(labels).long())
    for _ in range(MLP_STEPS):
        state, metrics = step(state, None, batch)
    for name, value in state.params.items():
        np.testing.assert_allclose(ranks[0][f"mlp_params/{name}"], value.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    np.testing.assert_allclose(compute(metrics)["loss"], ranks[0]["mlp_losses"][-1], rtol=1e-4)


def test_loader_rows_and_global_batch_match_jax(ranks):
    """Rank ``r`` holds rows ``r::4`` of each of JAX's one-process global
    batches (``tests/test_multihost.py:103-119``), and the stitched
    ``make_global_batch`` view is JAX's device order, rank 0's rows first
    (``:122-139``)."""
    from tpu_parallel.data import DataLoader as JDataLoader
    from tpu_parallel.data import TokenDataset as JTokenDataset

    ds = JTokenDataset(_corpus(), seq_len=16)
    ref = JDataLoader(ds, jax_make_mesh(JMeshConfig(data=1), devices=jax.devices()[:1]),
                      global_batch_size=8, seed=7)
    for step in range(3):
        epoch, b = divmod(step, ref.batches_per_epoch)
        rows = (ref._epoch_order(epoch) + ref._window_offset)[b * 8:(b + 1) * 8]
        stitched = ds.batch(np.concatenate([rows[r::NUM_RANKS] for r in range(NUM_RANKS)]))
        for r, out in enumerate(ranks):
            assert int(out["loader_local_batch_size"]) == 2
            np.testing.assert_array_equal(out["loader_local"][step],
                                          ds.batch(rows[r::NUM_RANKS]).tokens)
            np.testing.assert_array_equal(out["loader_global"][step], stitched.tokens)


@functools.lru_cache(maxsize=None)
def _jax_trainer(impl, batch_kind="example", steps=3):
    """Losses and exported masters of JAX's Trainer on data=4 from its init."""
    trainer = JTrainer(JTrainerConfig(**{**TRAINER_KW, "model_overrides": dict(attn_impl=impl)}),
                       mesh=_mesh4())
    state = trainer.init()
    _, example, packed = _trainer_inputs()
    nb = example if batch_kind == "example" else packed
    batch = JTextBatch(**{k: jnp.asarray(v) for k, v in nb.items()})
    losses = []
    for _ in range(steps):
        state, metrics = trainer.funcs.step_fn(state, None, batch)
        losses.append(jax_compute(metrics)["loss"])
    return losses, jax.tree.map(np.asarray, export_single_device_params(state.params))


def _assert_masters_close(got, want_tree, cfg):
    """Each master within a relative L2 error of 3e-5 of JAX's, the key
    slice of the qkv bias left out (``tests/test_torch_train.py``)."""
    want = params_from_jax(want_tree, cfg, dtype=torch.float32)
    dh = cfg.head_dim
    not_key = ((torch.arange(3 * cfg.d_model) % (3 * dh)) // dh != 1).numpy()
    for name, w in want.items():
        g, w = got[name], w.numpy()
        if name.endswith("attn.qkv.bias"):
            g, w = g[not_key], w[not_key]
        rel = float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))
        assert rel <= 3e-5, (name, rel)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_trainer_dp_matches_jax(ranks, impl):
    """``Trainer`` on ``tiny`` over ``data=4`` against JAX's ``Trainer(config,
    mesh=...)``: three steps from the same init on JAX's global example
    batch, each rank on its block (flash: the port's plain versions against
    JAX's interpret-mode kernels)."""
    want_losses, want_params = _jax_trainer(impl)
    cfg = Trainer(TrainerConfig(**TRAINER_KW), device="cpu").model_config
    for out in ranks:
        np.testing.assert_allclose(out[f"trainer_{impl}_losses"], want_losses, rtol=TOL)
        _assert_masters_close(_leaves(out, f"trainer_{impl}"), want_params, cfg)
    _assert_replicas_equal(ranks, f"trainer_{impl}")


def test_trainer_dp_takes_each_ranks_own_mean(ranks):
    """A packed batch whose ranks count different tokens: the DP step
    averages each rank's own token mean, as JAX's ``pmean`` of per-device
    means does, so two steps agree with JAX and not with the one-process
    step on the same rows (the token-weighted mean of each minibatch)."""
    counts = [float(out["packed_local_tokens"]) for out in ranks]
    assert len(set(counts)) > 1, counts
    want_losses, want_params = _jax_trainer("xla", "packed", steps=2)
    single = Trainer(TrainerConfig(**TRAINER_KW), device="cpu")
    cfg = single.model_config
    params0, _, packed = _trainer_inputs()
    state = single.init(params_from_jax(params0, cfg, dtype=torch.float32))
    batch = TextBatch(**{k: torch.from_numpy(v.copy()).long() if k in ("tokens", "targets",
                                                                       "positions")
                         else torch.from_numpy(v.copy()) for k, v in packed.items()})
    batch.segment_ids = batch.segment_ids.int()
    for _ in range(2):
        state, _ = single.step_fn(state, None, batch)
    for out in ranks:
        np.testing.assert_allclose(out["packed_losses"], want_losses, rtol=TOL)
        got = _leaves(out, "packed")
        _assert_masters_close(got, want_params, cfg)
        worst = max(float(np.linalg.norm(got[n] - p.numpy()) / np.linalg.norm(p.numpy()))
                    for n, p in state.params.items() if np.linalg.norm(p.numpy()) > 0)
        assert worst > 100 * 3e-5, worst
    _assert_replicas_equal(ranks, "packed")


def test_dropout_under_dp(ranks):
    """Dropout 0.1 over data=4: the same rows give each rank its own masks
    (four losses), the same generator state repeats them, and the
    replicated generator and masters stay equal across ranks."""
    losses = [out["dropout_loss"] for out in ranks]
    assert len({float(x[0]) for x in losses}) == NUM_RANKS
    for x in losses:
        assert x[0] == x[1]
    for out in ranks[1:]:
        np.testing.assert_array_equal(out["dropout_rng_state"], ranks[0]["dropout_rng_state"])
    _assert_replicas_equal(ranks, "dropout")


def test_fit_under_dp(ranks):
    """``fit`` over data=4 with checkpoints and held-out evaluation every 2
    steps and keep-best: rank 0 writes and no other rank does, every rank
    sees the same (synced) evaluation losses, so all take the same
    keep-best decisions; a second trainer resumes at step 4 on every rank;
    a loss made non-finite on rank 1 alone at step 7 is seen synced by
    every rank, which all roll back to step 6 and retry; fingerprints are
    equal across ranks."""
    import json

    writes = ranks[0]["fit_writes"].tolist()
    assert [w for w in writes if w.startswith("ckpt:")] == ["ckpt:2", "ckpt:4"]
    assert "best:2" in writes and set(writes) <= {"ckpt:2", "ckpt:4", "best:2", "best:4"}
    best = json.loads(str(ranks[0]["fit_best"]))
    assert f"best:{best['step']}" == [w for w in writes if w.startswith("best:")][-1]
    assert ranks[0]["fit_writes_all"].tolist()[len(writes):] == ["ckpt:6", "ckpt:8"]
    for out in ranks:
        assert len(out["fit_eval_losses"]) == 2
        np.testing.assert_array_equal(out["fit_eval_losses"], ranks[0]["fit_eval_losses"])
        assert best["loss"] == min(out["fit_eval_losses"])
    for out in ranks[1:]:
        assert out["fit_writes_all"].size == 0
    for out in ranks:
        assert out["resume_steps_seen"].tolist() == [4, 5]
        assert out["rollback_raised"].tolist() == [7]
        assert out["rollback_steps_seen"].tolist() == [6, 6, 7]
        assert int(out["rollback_final_step"]) == 8 and bool(out["rollback_finite"])
        for key in ("fit_fingerprint", "resume_fingerprint", "rollback_fingerprint"):
            assert str(out[key]) == str(ranks[0][key])
    assert str(ranks[0]["fit_fingerprint"]) != str(ranks[0]["resume_fingerprint"])


def test_cli_trains_mlp_dp_cpu():
    """``python -m tpu_parallel_torch.train --config=mlp_dp_cpu`` runs its
    ranks as gloo CPU processes (4 here, and a data axis of 4: the
    config's 8 cut to keep the suite short) and its logged loss falls."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-m", "tpu_parallel_torch.train",
                          "--config=mlp_dp_cpu", "--config.simulate_cpu_devices=4",
                          "--config.mesh.data=4", "--config.steps=10"], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    topology = [line for line in out.stdout.splitlines() if line.startswith("topology: ")]
    assert len(topology) == 1 and '"process_count": 4' in topology[0]
    assert '"backend": "gloo"' in topology[0]
    losses = [float(x) for x in re.findall(r"^step \d+: .*?loss=([0-9.]+)", out.stdout,
                                            re.MULTILINE)]
    assert len(losses) == 2 and losses[-1] < losses[0], out.stdout
