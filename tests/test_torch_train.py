"""Port parity: the training step of the PyTorch port against the JAX package.

``make_gpt_loss`` loss and gradients (xla and flash attention, each remat
policy), gradient accumulation, the learning-rate schedules and a short
trajectory of the whole ``Trainer`` step, on bridged ``tiny_test`` weights
and numpy batches made from a seed.  fp32 on the CPU.

Tolerances: loss and gradients atol = rtol = 1e-5 over the max |reference|
of each leaf (fp32 sums in another order through 4 layers); schedules
rtol 1e-6 (optax evaluates in fp32, the port in Python floats); the
trajectory's losses rtol 1e-5 and its final weights a relative L2 error of
3e-5 per leaf.  AdamW's update m / (sqrt(v) + 1e-8) has size ~lr whatever
the gradient's size, so the fp32 rounding noise of a gradient (~1e-7
relative) reaches the weights undamped; the zero-initialized biases, whose
whole value is six such updates, show ~1e-5.  The key slice of the qkv bias
is left out: its gradient is exactly zero in exact arithmetic (a bias on
every key adds one constant to a query's scores, which the softmax
ignores), so both sides step it by normalized rounding noise.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpu_parallel.core.losses import make_lm_loss as jax_make_lm_loss
from tpu_parallel.core.metrics import compute as jax_compute
from tpu_parallel.core.state import TextBatch as JTextBatch
from tpu_parallel.models import gpt as jgpt
from tpu_parallel.parallel.tp import export_single_device_params
from tpu_parallel.runtime import MeshConfig, make_mesh
from tpu_parallel.train_lib import Trainer as JTrainer
from tpu_parallel.train_lib import TrainerConfig as JTrainerConfig
from tpu_parallel.train_lib import make_lr_schedule as jax_schedule
from tpu_parallel_torch.core.accumulate import accumulate_gradients
from tpu_parallel_torch.core.losses import make_lm_loss
from tpu_parallel_torch.core.metrics import accumulate_metrics, compute, metric
from tpu_parallel_torch.core.state import TextBatch, TrainState, get_num_params
from tpu_parallel_torch.models import GPTLM, tiny_test
from tpu_parallel_torch.models.convert import params_from_jax
from tpu_parallel_torch.models.gpt import make_gpt_loss
from tpu_parallel_torch.train_lib import Trainer, TrainerConfig, make_lr_schedule, make_optimizer
from tpu_parallel_torch.utils.profiling import mfu, peak_flops

TOL = 1e-5


def _np_batch(seed, b=4, s=32, vocab=256):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, size=(b, s + 1), dtype=np.int32)
    mask = (rng.random((b, s)) > 0.2).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    return dict(tokens=tokens[:, :-1], targets=tokens[:, 1:], loss_mask=mask, positions=pos)


def _jax_batch(nb):
    return JTextBatch(**{k: jnp.asarray(v) for k, v in nb.items()})


def _torch_batch(nb):
    return TextBatch(tokens=torch.from_numpy(nb["tokens"]).long(),
                     targets=torch.from_numpy(nb["targets"]).long(),
                     loss_mask=torch.from_numpy(nb["loss_mask"]),
                     positions=torch.from_numpy(nb["positions"]).long())


def _assert_leaves_close(got, want):
    """Each port gradient within TOL * max |reference| of the JAX one."""
    for name, w in want.items():
        scale = max(float(w.abs().max()), 1e-30)
        err = float((got[name] - w).abs().max())
        assert err <= TOL * scale, (name, err, scale)


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(impl):
    cfg = jgpt.tiny_test(remat=False, attn_impl=impl)
    model = jgpt.GPTLM(cfg)
    nb = _np_batch(1)
    params = model.init(jax.random.PRNGKey(5), jnp.asarray(nb["tokens"]), train=False)["params"]
    loss_fn = jgpt.make_gpt_loss(cfg)
    (loss, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        params, model.apply, _jax_batch(nb), jax.random.PRNGKey(0))
    to_np = functools.partial(jax.tree.map, np.asarray)
    return nb, to_np(params), float(loss), jax_compute(metrics), to_np(grads)


def _port_model(params, impl, **overrides):
    cfg = tiny_test(attn_impl=impl, **overrides)
    model = GPTLM(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params, cfg))
    return model, cfg


@pytest.mark.parametrize("remat", ["none", "full", "proj_attn"])
@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_gpt_loss_and_grads_match_jax(impl, remat):
    nb, params, want_loss, want_metrics, want_grads = _jax_loss_and_grads(impl)
    overrides = dict(remat=False) if remat == "none" else dict(remat=True, remat_policy=remat)
    model, cfg = _port_model(params, impl, **overrides)
    loss, metrics = make_gpt_loss(cfg)(model, _torch_batch(nb))
    loss.backward()
    np.testing.assert_allclose(loss.item(), want_loss, rtol=TOL)
    got_metrics = compute({k: (s.detach(), c) for k, (s, c) in metrics.items()})
    for key, value in want_metrics.items():
        np.testing.assert_allclose(got_metrics[key], value, rtol=TOL)
    grads = {n: p.grad for n, p in model.named_parameters()}
    _assert_leaves_close(grads, params_from_jax(want_grads, cfg, dtype=torch.float32))


def test_lm_loss_matches_jax():
    """``make_lm_loss`` (the full-logits loss of ``core/losses.py``) against
    the JAX one, on the same weights and masked batch."""
    nb, params, want_loss, _, _ = _jax_loss_and_grads("xla")
    jm = jgpt.GPTLM(jgpt.tiny_test(remat=False))
    loss_j, metrics_j = jax_make_lm_loss()(jax.tree.map(jnp.asarray, params), jm.apply,
                                           _jax_batch(nb), jax.random.PRNGKey(0))
    model, _ = _port_model(params, "xla", remat=False)
    loss, metrics = make_lm_loss()(model, _torch_batch(nb))
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=TOL)
    np.testing.assert_allclose(loss.item(), want_loss, rtol=TOL)
    got = compute({k: (s.detach(), c) for k, (s, c) in metrics.items()})
    for key, value in jax_compute(metrics_j).items():
        np.testing.assert_allclose(got[key], value, rtol=TOL)


def test_metrics_sum_and_count():
    running = accumulate_metrics(None, {"loss": metric(6.0, 3)})
    running = accumulate_metrics(running, {"loss": metric(torch.tensor(2.0), 1)})
    assert all(t.dtype == torch.float32 for t in running["loss"])
    assert compute(running) == {"loss": 2.0}
    assert compute({"loss": metric(0.0, 0)}) == {"loss": 0.0}


def test_accumulate_gradients_two_minibatches():
    """Mean of the two minibatches' gradients, summed metrics, and the
    divisibility error, as the JAX ``accumulate_gradients``."""
    nb, params, _, _, _ = _jax_loss_and_grads("xla")
    jcfg = jgpt.tiny_test(remat=False)
    jm = jgpt.GPTLM(jcfg)
    jloss = jgpt.make_gpt_loss(jcfg)
    halves = [{k: v[i * 2:(i + 1) * 2] for k, v in nb.items()} for i in range(2)]
    want = [jax.grad(lambda p, b: jloss(p, jm.apply, b, jax.random.PRNGKey(0))[0])(
        jax.tree.map(jnp.asarray, params), _jax_batch(h)) for h in halves]
    want_grads = jax.tree.map(lambda a, b: (np.asarray(a) + np.asarray(b)) / 2, *want)
    want_loss = sum(float(jloss(jax.tree.map(jnp.asarray, params), jm.apply, _jax_batch(h),
                                jax.random.PRNGKey(0))[1]["loss"][0]) for h in halves)

    model, cfg = _port_model(params, "xla", remat=False)
    state = TrainState.create(model, make_optimizer(TrainerConfig()), torch.Generator())
    grads, metrics = accumulate_gradients(state, _torch_batch(nb), state.rng, 2, make_gpt_loss(cfg))
    _assert_leaves_close(grads, params_from_jax(want_grads, cfg, dtype=torch.float32))
    np.testing.assert_allclose(float(metrics["loss"][0]), want_loss, rtol=TOL)
    assert float(metrics["loss"][1]) == nb["loss_mask"].sum()
    assert all(p.grad is None for p in model.parameters())
    with pytest.raises(ValueError, match="not divisible"):
        accumulate_gradients(state, _torch_batch(nb), state.rng, 3, make_gpt_loss(cfg))


@pytest.mark.parametrize("kind", ["cosine", "linear", "constant"])
@pytest.mark.parametrize("warmup,steps", [(3, 12), (0, 5), (4, 4)])
def test_lr_schedule_matches_optax(kind, warmup, steps):
    kw = dict(lr_schedule=kind, warmup_steps=warmup, steps=steps, learning_rate=3e-4)
    want = jax_schedule(JTrainerConfig(**kw))
    got = make_lr_schedule(TrainerConfig(**kw))
    for count in range(steps + 4):
        np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-6, atol=1e-12)
    if warmup:
        assert got(0) == 0.0


def _jax_trajectory(steps):
    config = JTrainerConfig(model="tiny", steps=steps, warmup_steps=2, num_minibatches=2)
    trainer = JTrainer(config, mesh=make_mesh(MeshConfig(data=1), devices=jax.devices()[:1]))
    state = trainer.init()
    to_np = lambda params: jax.tree.map(np.asarray, export_single_device_params(params))
    params0 = to_np(state.params)
    batch = jax.tree.map(np.asarray, trainer.example_batch)
    losses = []
    for _ in range(steps):
        state, metrics = trainer.funcs.step_fn(state, None, trainer.example_batch)
        losses.append(jax_compute(metrics)["loss"])
    return params0, batch, losses, to_np(state.params)


def test_trainer_trajectory_matches_jax():
    """Six steps of the JAX Trainer (tiny, warmup 2, 2 minibatches, one
    device) against the port's Trainer from the same init and batch."""
    steps = 6
    params0, jbatch, want_losses, want_params = _jax_trajectory(steps)
    trainer = Trainer(TrainerConfig(model="tiny", steps=steps, warmup_steps=2,
                                    num_minibatches=2), device="cpu")
    cfg = trainer.model_config
    state = trainer.init(params_from_jax(params0, cfg, dtype=torch.float32))
    batch = TextBatch(tokens=torch.from_numpy(jbatch.tokens).long(),
                      targets=torch.from_numpy(jbatch.targets).long(),
                      loss_mask=torch.from_numpy(jbatch.loss_mask),
                      positions=torch.from_numpy(jbatch.positions).long())
    losses = []
    for _ in range(steps):
        state, metrics = trainer.step_fn(state, None, batch)
        losses.append(compute(metrics)["loss"])
    np.testing.assert_allclose(losses, want_losses, rtol=TOL)
    assert losses[-1] < losses[0]
    want = params_from_jax(want_params, cfg, dtype=torch.float32)
    # [q | k | v] per head: drop the k slice of each head from the qkv bias
    dh = cfg.head_dim
    not_key = (torch.arange(3 * cfg.d_model) % (3 * dh)) // dh != 1
    for name, w in want.items():
        got = state.params[name]
        if name.endswith("attn.qkv.bias"):
            got, w = got[not_key], w[not_key]
        rel = float((got - w).norm() / w.norm().clamp(min=1e-30))
        assert rel <= 3e-5, (name, rel)


def test_trainer_train_reports_throughput_and_masters():
    """``train()`` returns the running loss and accuracy and tokens/s (no
    MFU on the CPU); bf16 modules keep fp32 masters, rounded into the
    module after each step."""
    config = TrainerConfig(model="tiny", steps=3, warmup_steps=1, global_batch_size=4,
                           num_minibatches=2, log_every=2,
                           model_overrides=dict(dtype=torch.bfloat16))
    trainer = Trainer(config, device="cpu")
    logged = []
    out = trainer.train(log_fn=lambda step, m: logged.append(step))
    assert logged == [2, 3]
    assert set(out) == {"loss", "accuracy", "tokens_per_sec"}
    assert np.isfinite(out["loss"]) and out["tokens_per_sec"] > 0
    state = trainer.state
    assert state.step == 3 and get_num_params(state) == get_num_params(trainer.model)
    for name, p in trainer.model.named_parameters():
        master = state.params[name]
        assert master.dtype == torch.float32
        assert torch.equal(p.detach(), master.to(p.dtype))
    assert peak_flops("cpu") is None and mfu(1e6, trainer.model_config, "cpu") is None
    assert peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert peak_flops("NVIDIA H100 PCIe") == 756e12


def test_trainer_refuses_what_it_does_not_port():
    with pytest.raises(NotImplementedError, match="lion"):
        make_optimizer(TrainerConfig(optimizer="lion"))
    with pytest.raises(NotImplementedError, match="ema"):
        Trainer(TrainerConfig(model="tiny", ema_decay=0.99), device="cpu")
    with pytest.raises(NotImplementedError, match="dots"):
        model = GPTLM(tiny_test(remat=True, remat_policy="dots"), device="cpu")
        model(torch.zeros(1, 8, dtype=torch.long))
