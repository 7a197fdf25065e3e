"""Port parity: the training step of the PyTorch port against the JAX package.

``make_gpt_loss`` loss and gradients (xla and flash attention, each remat
policy, the chunked loss), gradient accumulation, the learning-rate
schedules, dropout, and short trajectories of the whole ``Trainer`` step
(adamw, lion, sgd, adamw with an EMA shadow) with ``evaluate``, on bridged
``tiny_test`` weights and numpy batches made from a seed.  fp32 on the CPU.

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
from tpu_parallel.train_lib import make_optimizer as jax_make_optimizer
from tpu_parallel_torch.core.accumulate import accumulate_gradients
from tpu_parallel_torch.core.losses import make_lm_loss
from tpu_parallel_torch.core.metrics import accumulate_metrics, compute, metric
from tpu_parallel_torch.core.state import TextBatch, TrainState, get_num_params
from tpu_parallel_torch.models import GPTLM, tiny_test
from tpu_parallel_torch.models.convert import params_from_jax
from tpu_parallel_torch.models.gpt import make_gpt_loss
from tpu_parallel_torch.train_lib import Trainer, TrainerConfig, make_lr_schedule, make_optimizer
from tpu_parallel_torch.utils.profiling import mfu, peak_flops

# one torch intra-op thread per test process: under pytest-xdist several
# processes share the cores, and torch's default (a thread per core in each)
# oversubscribes them
torch.set_num_threads(1)

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


@pytest.mark.parametrize("remat", ["none", "full", "proj", "proj_attn", "dots"])
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


@functools.lru_cache(maxsize=None)
def _jax_trajectory(steps, **kw):
    """The JAX Trainer's losses, final masters (and EMA shadow) and
    ``eval_fn`` metrics on its example batch, from its init."""
    config = JTrainerConfig(model="tiny", steps=steps, warmup_steps=2, num_minibatches=2, **kw)
    trainer = JTrainer(config, mesh=make_mesh(MeshConfig(data=1), devices=jax.devices()[:1]))
    state = trainer.init()
    to_np = lambda params: jax.tree.map(np.asarray, export_single_device_params(params))
    params0 = to_np(state.params)
    batch = jax.tree.map(np.asarray, trainer.example_batch)
    losses = []
    for _ in range(steps):
        state, metrics = trainer.funcs.step_fn(state, None, trainer.example_batch)
        losses.append(jax_compute(metrics)["loss"])
    ema = None if state.ema_params is None else to_np(state.ema_params)
    evaluated = jax_compute(trainer.funcs.eval_fn(state, None, trainer.example_batch))
    return params0, batch, losses, to_np(state.params), ema, evaluated


def _assert_weights_close(got_params, want_tree, cfg):
    """Each weight within a relative L2 error of 3e-5 of the JAX one, the
    key slice of the qkv bias left out (see the module docstring)."""
    want = params_from_jax(want_tree, cfg, dtype=torch.float32)
    # [q | k | v] per head: drop the k slice of each head from the qkv bias
    dh = cfg.head_dim
    not_key = (torch.arange(3 * cfg.d_model) % (3 * dh)) // dh != 1
    for name, w in want.items():
        got = got_params[name]
        if name.endswith("attn.qkv.bias"):
            got, w = got[not_key], w[not_key]
        rel = float((got - w).norm() / w.norm().clamp(min=1e-30))
        assert rel <= 3e-5, (name, rel)


def test_trainer_trajectory_matches_jax():
    """Six steps of the JAX Trainer (tiny, warmup 2, 2 minibatches, one
    device, AdamW) against the port's Trainer from the same init and batch:
    losses, masters, and ``evaluate`` against the JAX ``eval_fn``."""
    _check_trajectory()


@pytest.mark.parametrize("kw", [dict(optimizer="lion"), dict(optimizer="sgd"),
                                dict(ema_decay=0.9)], ids=["lion", "sgd", "adamw_ema"])
def test_trainer_trajectory_optimizers_match_jax(kw):
    """As above for lion, sgd (after decayed weights, momentum 0.9) and
    AdamW with an EMA shadow (compared too; the JAX ``eval_fn`` and the
    port's ``evaluate`` both read it)."""
    _check_trajectory(**kw)


def _check_trajectory(**kw):
    steps = 6
    params0, jbatch, want_losses, want_params, want_ema, want_eval = _jax_trajectory(
        steps, **kw)
    trainer = Trainer(TrainerConfig(model="tiny", steps=steps, warmup_steps=2,
                                    num_minibatches=2, **kw), device="cpu")
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
    _assert_weights_close(state.params, want_params, cfg)
    assert (state.ema_params is None) == (want_ema is None)
    if want_ema is not None:
        _assert_weights_close(state.ema_params, want_ema, cfg)
        assert not torch.equal(state.ema_params["lm_head.weight"], state.params["lm_head.weight"])
    before = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    got_eval = trainer.evaluate(batch_iter=iter([batch]), steps=1)
    for key, value in want_eval.items():
        np.testing.assert_allclose(got_eval[key], value, rtol=TOL)
    assert all(torch.equal(p, before[n]) for n, p in trainer.model.named_parameters())


def test_optimizer_refusals_match_jax():
    """Unknown optimizers and adafactor raise ``ValueError``, as the JAX
    ``make_optimizer`` does."""
    for name in ("adafactor", "adam"):
        with pytest.raises(ValueError, match=name):
            jax_make_optimizer(JTrainerConfig(optimizer=name))
        with pytest.raises(ValueError, match=name):
            make_optimizer(TrainerConfig(optimizer=name))


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_chunked_loss_matches_jax_and_unchunked(impl):
    """``loss_chunk=8`` (4 chunks of the 32 positions): loss and gradients
    equal JAX's chunked loss and the port's unchunked one; a chunk that
    does not divide the sequence raises, as in JAX."""
    nb, params, want_loss, want_metrics, want_grads = _jax_loss_and_grads(impl)
    jcfg = jgpt.tiny_test(remat=False, attn_impl=impl, loss_chunk=8)
    jm = jgpt.GPTLM(jcfg)
    (jloss, _), jgrads = jax.value_and_grad(jgpt.make_gpt_loss(jcfg), has_aux=True)(
        jax.tree.map(jnp.asarray, params), jm.apply, _jax_batch(nb), jax.random.PRNGKey(0))
    np.testing.assert_allclose(float(jloss), want_loss, rtol=TOL)
    model, cfg = _port_model(params, impl, remat=False, loss_chunk=8)
    loss, metrics = make_gpt_loss(cfg)(model, _torch_batch(nb))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=TOL)
    got_metrics = compute({k: (s.detach(), c) for k, (s, c) in metrics.items()})
    for key, value in want_metrics.items():
        np.testing.assert_allclose(got_metrics[key], value, rtol=TOL)
    grads = {n: p.grad for n, p in model.named_parameters()}
    _assert_leaves_close(grads, params_from_jax(jax.tree.map(np.asarray, jgrads), cfg,
                                                dtype=torch.float32))
    _assert_leaves_close(grads, params_from_jax(want_grads, cfg, dtype=torch.float32))
    bad, bad_cfg = _port_model(params, impl, remat=False, loss_chunk=5)
    with pytest.raises(ValueError, match="not divisible by loss_chunk=5"):
        make_gpt_loss(bad_cfg)(bad, _torch_batch(nb))


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
    """JAX's refusal of the causal objective on a bidirectional model, in
    its words (the MLM objective itself trains: ``tests/test_torch_encoder.py``;
    here one step, and its refusal under 1F1B); a data axis above 1 is data parallelism, a model axis above 1
    tensor parallelism, a pipe axis above 1 pipeline parallelism and a seq
    axis above 1 sequence parallelism, which without a process group meet
    JAX's errors for a mesh the devices do not cover (the DP, TP, PP and SP
    runs are ``tests/test_torch_dp.py``'s, ``tests/test_torch_tp.py``'s,
    ``tests/test_torch_pp.py``'s and ``tests/test_torch_sp.py``'s, which
    also holds JAX's refusal of a seq axis with dense attention);
    ``gpt2_125m_tp`` loads; a one-device mesh is accepted."""
    from tpu_parallel_torch.configs import get_config

    one = dict(mesh=MeshConfig(data=1), model_overrides=dict(bidirectional=True))
    with pytest.raises(ValueError, match="objective='causal'") as want:
        JTrainer(JTrainerConfig(model="tiny", **one),
                 mesh=make_mesh(MeshConfig(data=1), devices=jax.devices()[:1]))
    with pytest.raises(ValueError, match="objective='causal'") as got:
        Trainer(TrainerConfig(model="tiny", **one), device="cpu")
    assert str(got.value) == str(want.value)
    mlm = Trainer(TrainerConfig(model="tiny", objective="mlm", global_batch_size=2, steps=1,
                                model_overrides=dict(bidirectional=True)), device="cpu")
    assert np.isfinite(mlm.train()["loss"])
    with pytest.raises(NotImplementedError, match="objective='mlm' under pipe_schedule='1f1b'"):
        Trainer(TrainerConfig(model="tiny", objective="mlm",
                              model_overrides=dict(pipe_schedule="1f1b")), device="cpu")
    jax_mesh = functools.partial(make_mesh, devices=jax.devices()[:1])
    for mesh in (dict(data=2), dict(data=4), dict(data=-1, model=2), dict(data=1, model=2),
                 dict(data=-1, pipe=4), dict(data=2, seq=2), dict(data=1, seq=4)):
        with pytest.raises(ValueError, match="1 devices") as want:
            jax_mesh(MeshConfig(**mesh))
        with pytest.raises(ValueError, match="1 devices") as got:
            Trainer(TrainerConfig(model="tiny", mesh=mesh), device="cpu")
        assert str(got.value) == str(want.value)
    assert get_config("gpt2_125m_tp")["mesh"] == dict(data=1, model=-1, pipe=1, seq=1)
    Trainer(TrainerConfig(model="tiny", mesh=dict(data=-1, model=1, pipe=1, seq=1)),
            device="cpu")
    Trainer(TrainerConfig(model="tiny", mesh=MeshConfig(data=1)), device="cpu")


def _dropout_grads(remat, rate=0.1, seed=7):
    """Loss and gradients of the tiny model with dropout, from a generator
    seeded ``seed``."""
    nb, params, _, _, _ = _jax_loss_and_grads("xla")
    overrides = dict(remat=False) if remat == "none" else dict(remat=True, remat_policy=remat)
    model, cfg = _port_model(params, "xla", dropout_rate=rate, **overrides)
    loss, _ = make_gpt_loss(cfg)(model, _torch_batch(nb), torch.Generator().manual_seed(seed))
    loss.backward()
    return loss.item(), {n: p.grad for n, p in model.named_parameters()}


@pytest.mark.parametrize("remat", ["full", "proj", "proj_attn", "dots"])
def test_dropout_gradients_equal_under_remat(remat):
    """The recompute under remat redraws the forward's masks: gradients
    with dropout and remat equal those without remat from one generator
    state (and differ from another state's)."""
    want_loss, want = _dropout_grads("none")
    loss, got = _dropout_grads(remat)
    np.testing.assert_allclose(loss, want_loss, rtol=TOL)
    _assert_leaves_close(got, want)
    other_loss, _ = _dropout_grads(remat, seed=8)
    assert other_loss != loss


def test_dropout_rate_zero_and_eval_are_the_plain_path():
    """Rate 0 in training, and any rate out of training, are bitwise the
    forward without dropout; a training forward at rate 0.3 differs."""
    nb, params, _, _, _ = _jax_loss_and_grads("xla")
    tokens = torch.from_numpy(nb["tokens"]).long()
    plain, _ = _port_model(params, "xla", remat=False)
    with torch.no_grad():
        want = plain(tokens)
        zero, _ = _port_model(params, "xla", remat=False, dropout_rate=0.0)
        assert torch.equal(zero(tokens, train=True, rng=torch.Generator()), want)
        drop, _ = _port_model(params, "xla", remat=False, dropout_rate=0.3)
        assert torch.equal(drop(tokens), want)
        assert torch.equal(drop(tokens, train=False, rng=torch.Generator()), want)
        assert not torch.equal(drop(tokens, train=True, rng=torch.Generator()), want)
    with pytest.raises(ValueError, match="rng"):
        drop(tokens, train=True)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_keeps_its_share_and_scales(rate):
    """In training, the kept share is within 3 sigma of 1 - rate and every
    kept value is x / (1 - rate) in x's dtype; the rest are 0."""
    from tpu_parallel_torch.models.layers import dropout

    n = 1 << 16
    x = torch.randn(n, generator=torch.Generator().manual_seed(0)) + 4.0
    for dtype in (torch.float32, torch.bfloat16):
        xd = x.to(dtype)
        out = dropout(xd, rate, torch.Generator().manual_seed(1))
        kept = out != 0
        share = kept.float().mean().item()
        sigma = ((1 - rate) * rate / n) ** 0.5
        assert abs(share - (1 - rate)) <= 3 * sigma, (share, sigma)
        assert torch.equal(out[kept], xd[kept] / (1 - rate))
        assert out.dtype == dtype
