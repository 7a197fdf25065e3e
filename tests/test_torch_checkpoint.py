"""Port parity: checkpoints and serving weight sets (``checkpoint/io.py``).

Train-state checkpoints: the round trip is bitwise (masters, moments,
step, generator, EMA shadow) and in place (every buffer keeps its
address), ``max_to_keep`` prunes, a missing checkpoint raises, EMA drift
restores both ways with a warning, a save followed at once by a step holds
the pre-step state, and a ``.tmp`` directory is never the latest step.
Serving weights: ``params_fingerprint`` equals the JAX package's digest on
the same fp32 and bf16 trees, scanned and unrolled; the manifest JSON has
JAX's keys (and, for the same weights, its fingerprint); a flipped byte
raises ``WeightsCorrupt``.  JAX is imported inside the tests that use it,
so the ``gpu`` case runs on the card without it.
"""

import dataclasses
import json
import os
import warnings

import numpy as np
import pytest
import torch

from tpu_parallel_torch.checkpoint import (
    Checkpointer,
    WeightsCorrupt,
    latest_weights_step,
    load_serving_weights,
    params_fingerprint,
    save_serving_weights,
)
from tpu_parallel_torch.train_lib import Trainer, TrainerConfig

# one torch intra-op thread per test process (pytest-xdist shares the cores)
torch.set_num_threads(1)


def _trainer(device="cpu", **kw):
    config = dict(model="tiny", global_batch_size=4, num_minibatches=2, steps=10,
                  warmup_steps=2, log_every=100, seed=3)
    config.update(kw)
    return Trainer(TrainerConfig(**config), device=device)


def _run(trainer, steps):
    if trainer.state is None:
        trainer.init()
    for _ in range(steps):
        trainer.step_fn(trainer.state, None, trainer.example_batch)
    return trainer.state


def _tensors(tree, prefix=""):
    """``{path: tensor}`` of every tensor in a state dict."""
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    if not isinstance(tree, (dict, list, tuple)):
        return {}
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        out.update(_tensors(v, f"{prefix}/{k}"))
    return out


def _assert_states_equal(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa["step"] == sb["step"]
    ta, tb = _tensors(sa), _tensors(sb)
    assert set(ta) == set(tb)
    for path in ta:
        assert torch.equal(ta[path].cpu(), tb[path].cpu()), path


@pytest.mark.parametrize("kw", [dict(), dict(ema_decay=0.9, model_overrides=dict(dropout_rate=0.1)),
                                dict(optimizer="lion"), dict(optimizer="sgd")],
                         ids=["adamw", "adamw_ema_dropout", "lion", "sgd"])
def test_checkpoint_roundtrip_is_bitwise_and_in_place(tmp_path, kw):
    t1 = _trainer(**kw)
    _run(t1, 3)
    ckpt = Checkpointer(str(tmp_path / "run"))
    ckpt.save(3, t1.state, wait=True)
    assert ckpt.latest_step == 3 and ckpt.bytes_on_disk(3) > 0

    t2 = _trainer(**kw)
    state = t2.init()
    addresses = {p: t.data_ptr() for p, t in _tensors(state.state_dict()).items()
                 if p != "/rng"}
    module = {n: p.data_ptr() for n, p in t2.model.named_parameters()}
    ckpt.restore(state)
    _assert_states_equal(t1.state, state)
    assert {p: t.data_ptr() for p, t in _tensors(state.state_dict()).items()
            if p != "/rng"} == addresses
    assert {n: p.data_ptr() for n, p in t2.model.named_parameters()} == module
    for (n, a), b in zip(t1.model.named_parameters(), t2.model.parameters()):
        assert torch.equal(a, b), n
    # the restored state continues exactly as the saved one does
    _run(t1, 1)
    _run(t2, 1)
    _assert_states_equal(t1.state, t2.state)
    ckpt.close()


def test_restore_overwrites_a_half_done_step(tmp_path):
    """A failure inside a step leaves gradients part-summed and masters
    partly written; the restore rewrites every field and clears them."""
    t = _trainer()
    _run(t, 2)
    ckpt = Checkpointer(str(tmp_path / "run"))
    ckpt.save(2, t.state, wait=True)
    saved = _trainer()
    saved.init()
    ckpt.restore(saved.state)
    loss, _ = t.loss_fn(t.model, t.example_batch, t.state.rng)
    loss.backward()
    t.state.accumulate_grads()
    loss, _ = t.loss_fn(t.model, t.example_batch, t.state.rng)
    loss.backward()
    with torch.no_grad():
        next(iter(t.state.params.values())).add_(1.0)
    ckpt.restore(t.state)
    _assert_states_equal(t.state, saved.state)
    assert all(float(g.abs().max()) == 0 for g in t.state.grads.values())
    assert all(p.grad is None for p in t.model.parameters())


def test_max_to_keep_missing_and_tmp(tmp_path):
    t = _trainer()
    _run(t, 1)
    run = str(tmp_path / "run")
    ckpt = Checkpointer(run, max_to_keep=2)
    with pytest.raises(FileNotFoundError):
        ckpt.restore(t.state)
    with pytest.raises(FileNotFoundError):
        ckpt.load(7)
    for step in (1, 2, 3):
        ckpt.save(step, t.state)
    ckpt.wait()
    assert sorted(os.listdir(run)) == ["2", "3"]
    # a write cut short leaves <step>.tmp/, which is never the latest step
    os.makedirs(os.path.join(run, "9.tmp"))
    torch.save({"step": 9}, os.path.join(run, "9.tmp", "state.pt"))
    assert ckpt.latest_step == 3
    with pytest.raises(FileNotFoundError):
        ckpt.load(9)
    ckpt.close()


def test_async_save_then_step_holds_the_pre_step_state(tmp_path):
    """``save`` returns before the write; the step that follows at once
    updates the state in place, and the checkpoint still holds the state
    as it was when ``save`` was called."""
    t = _trainer(ema_decay=0.5)
    _run(t, 2)
    want = {p: v.clone() for p, v in _tensors(t.state.state_dict()).items()}
    ckpt = Checkpointer(str(tmp_path / "run"))
    ckpt.save(2, t.state)
    _run(t, 1)
    ckpt.wait()
    got = _tensors(ckpt.load(2))
    assert set(got) == set(want)
    assert all(torch.equal(got[p], want[p]) for p in want)
    assert not torch.equal(want["/params/lm_head.weight"], t.state.params["lm_head.weight"])
    ckpt.close()


def test_restore_across_ema_drift_both_ways(tmp_path):
    """EMA turned on or off across resumes of one run directory, as the JAX
    ``test_resume_toggling_ema_both_directions``: off -> on seeds the shadow
    from the restored masters, on -> off drops it; each warns."""
    run = str(tmp_path / "run")
    t1 = _trainer(steps=2)
    t1.fit(run, checkpoint_every=2)
    t2 = _trainer(steps=4, ema_decay=0.9)
    with pytest.warns(UserWarning, match="no usable 'ema_params'"):
        t2.fit(run, checkpoint_every=2)
    assert t2.state.step == 4 and t2.state.ema_params is not None
    t3 = _trainer(steps=6)
    with pytest.warns(UserWarning, match="dropping it"):
        t3.fit(run, checkpoint_every=10**9)
    assert t3.state.step == 6 and t3.state.ema_params is None
    # an EMA-less checkpoint restored directly: the shadow is reseeded
    fresh = _trainer(ema_decay=0.9)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fresh.restore_checkpoint(run, step=2)
    assert all(torch.equal(fresh.state.ema_params[n], p)
               for n, p in fresh.state.params.items())
    # any other mismatch raises
    other = _trainer(optimizer="lion")
    other.init()
    with pytest.raises(ValueError, match="opt_state"):
        Checkpointer(run).restore(other.state, step=6)


@pytest.fixture(scope="module")
def jax_trees():
    """JAX tiny init trees, scanned and unrolled, fp32 (numpy leaves)."""
    import jax
    import jax.numpy as jnp

    from tpu_parallel.models import gpt as jgpt

    trees = {}
    for scan in (True, False):
        cfg = jgpt.tiny_test(scan_layers=scan, remat=False)
        params = jgpt.GPTLM(cfg).init(jax.random.PRNGKey(4), jnp.zeros((1, 8), jnp.int32),
                                      train=False)["params"]
        trees[scan] = params
    return trees


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scan", [True, False], ids=["scanned", "unrolled"])
def test_params_fingerprint_matches_jax(jax_trees, scan, dtype):
    """The port's digest of ``params_to_jax`` of its weights equals the JAX
    digest of the JAX tree holding the same values."""
    import jax
    import jax.numpy as jnp

    from tpu_parallel.checkpoint.io import params_fingerprint as jax_fingerprint
    from tpu_parallel_torch.models import tiny_test
    from tpu_parallel_torch.models.convert import params_from_jax, params_to_jax

    tree = jax_trees[scan]
    if dtype == "bfloat16":
        tree = jax.tree.map(lambda x: x.astype(jnp.bfloat16), tree)
    want = jax_fingerprint(tree)
    cfg = tiny_test(scan_layers=scan)
    masters = params_from_jax(jax.tree.map(lambda x: np.asarray(x, np.float32), jax_trees[scan]),
                              cfg, dtype=torch.float32)
    ours = params_to_jax(masters, cfg)
    if dtype == "bfloat16":
        ours = _cast_tree(ours, torch.bfloat16)
    assert params_fingerprint(ours) == want
    # a numpy tree (bf16 as its raw bits, tagged) hashes alike
    from tpu_parallel_torch.serving.cache_pool import BFLOAT16_BITS

    as_numpy = _map_tree(ours, lambda t: t.view(torch.uint16).numpy().view(BFLOAT16_BITS)
                         if t.dtype == torch.bfloat16 else t.numpy())
    assert params_fingerprint(as_numpy) == want


def _map_tree(tree, fn):
    return {k: _map_tree(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _cast_tree(tree, dtype):
    return _map_tree(tree, lambda t: t.to(dtype))


def test_serving_weights_manifest_and_corruption(jax_trees, tmp_path):
    """A weight set round-trips with its manifest, whose JSON keys (and
    fingerprint, for the same weights) are the JAX package's; a flipped
    byte in the payload raises ``WeightsCorrupt``."""
    import jax

    from tpu_parallel.checkpoint.io import save_serving_weights as jax_save
    from tpu_parallel_torch.models import tiny_test
    from tpu_parallel_torch.models.convert import params_from_jax, params_to_jax

    tree = jax.tree.map(np.asarray, jax_trees[False])
    cfg = tiny_test(scan_layers=False)
    ours = params_to_jax(params_from_jax(tree, cfg, dtype=torch.float32), cfg)
    d = str(tmp_path / "weights")
    manifest = save_serving_weights(d, 3, ours, version="v2")
    assert manifest.version == "v2" and latest_weights_step(d) == 3
    jax_manifest = jax_save(str(tmp_path / "jax_weights"), 3, jax_trees[False], version="v2")
    assert dataclasses.asdict(manifest) == dataclasses.asdict(jax_manifest)
    ours_json = json.loads(open(os.path.join(d, "weights_manifest_3.json")).read())
    jax_json = json.loads(open(tmp_path / "jax_weights" / "weights_manifest_3.json").read())
    assert ours_json == jax_json

    restored, loaded = load_serving_weights(d)
    assert loaded == manifest
    flat = dict(_flat(restored))
    assert all(torch.equal(flat[k], v) for k, v in _flat(ours))
    like = _cast_tree(ours, torch.bfloat16)
    with pytest.raises(WeightsCorrupt):
        load_serving_weights(d, like=like)  # another dtype is another digest
    with pytest.raises(FileNotFoundError):
        load_serving_weights(str(tmp_path / "empty"))

    payload = os.path.join(d, "weights_3", "params.pt")
    raw = bytearray(open(payload, "rb").read())
    # a byte inside the largest tensor's data (the tail of the file holds
    # the archive's directory)
    raw[len(raw) // 2] ^= 0x01
    open(payload, "wb").write(bytes(raw))
    with pytest.raises(WeightsCorrupt):
        load_serving_weights(d, step=3)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", v


@pytest.mark.gpu
def test_async_save_orders_behind_the_stream_on_card(tmp_path):
    """On the card: the snapshot is enqueued on the current stream, so the
    in-place step that follows without a synchronize cannot reach it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    t = _trainer(device="cuda", ema_decay=0.5, model_overrides=dict(d_model=512, n_heads=8))
    _run(t, 2)
    torch.cuda.synchronize()
    want = {p: v.detach().cpu().clone() for p, v in _tensors(t.state.state_dict()).items()}
    ckpt = Checkpointer(str(tmp_path / "run"))
    torch.cuda._sleep(50_000_000)  # keep the stream busy past save()'s return
    ckpt.save(2, t.state)
    _run(t, 1)
    ckpt.wait()
    got = _tensors(ckpt.load(2))
    assert all(torch.equal(got[p], want[p]) for p in want)
    torch.cuda.synchronize()
    assert not torch.equal(want["/params/lm_head.weight"],
                           t.state.params["lm_head.weight"].cpu())
    ckpt.close()
