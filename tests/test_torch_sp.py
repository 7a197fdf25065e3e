"""Port parity: sequence parallelism (``ops/ring_attention.py``: the plain
and the flash-composed ring, ``combine_chunks``; ``ops/ulysses.py``; the
chunk wrapper ``flash_chunk_attention``; the model's seq-parallel
attention and positions, the Trainer, the gradient sync and the loader
over a seq axis) against the JAX package.

The multi-rank cases run once, in one 8-rank gloo group of CPU processes
(``tests/torch_dp_worker.py``, suite ``sp``), on JAX's meshes ``data=2,
seq=4`` (``tests/test_ring_attention.py``'s ``mesh_seq4``), ``data=4,
seq=2`` and ``data=2, seq=2, model=2``; JAX runs its ops and Trainers on the
same meshes over the test run's eight simulated devices (its ring-flash and
Ulysses' inner flash in Pallas interpret mode, as its own tests run them),
and the port starts from the same numpy inputs and JAX's inits.  Each rank
holds its seq block; it is compared with that block of JAX's result.

Tolerances (fp32): the ops' outputs and their q, k and v gradients against
JAX's same op atol = rtol = 1e-4 (online-softmax steps and the flash
tiles sum in another order); the chunk wrapper and ``combine_chunks``
against JAX's, out and lse 1e-5, gradients (through the lse cotangent)
1e-5; the Trainers' losses rtol 1e-5 and masters rtol 1e-4, atol 1e-5
with the qkv bias's key slice left out (``tests/test_torch_tp.py``); the
step-1 synced gradients against JAX's gradients of the same global loss
on one device rtol 1e-4, atol 1e-6 (``tests/test_tp.py``'s rule); the
loader's tokens exactly.
"""

import functools
import importlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import make_packed_segments
from jax.sharding import PartitionSpec as P
from torch_dp_worker import (SP_OP_CASES, SP_TRAINER_3D, SP_TRAINERS, SP_VARIANT_STEPS,
                             SP_VARIANTS, flat_tree, run_once)

from tpu_parallel.core import compute as jax_compute
from tpu_parallel.data import lm_batch as jax_lm_batch
from tpu_parallel.data.loader import DataLoader as JDataLoader
from tpu_parallel.data.loader import TokenDataset as JTokenDataset
from tpu_parallel.models import GPTLM as JGPTLM
from tpu_parallel.models import make_gpt_loss as jax_make_gpt_loss
from tpu_parallel.models import tiny_test as jax_tiny
from tpu_parallel.ops import ring_attention as jring
from tpu_parallel.ops.ulysses import ulysses_attention as jax_ulysses
from tpu_parallel.parallel.tp import export_single_device_params as jax_export
from tpu_parallel.runtime import MeshConfig as JMeshConfig
from tpu_parallel.runtime import make_mesh as jax_make_mesh
from tpu_parallel.train_lib import Trainer as JTrainer
from tpu_parallel.train_lib import TrainerConfig as JTrainerConfig
from tpu_parallel_torch.ops.ring_attention import NEG_INF, combine_chunks

# one torch intra-op thread per test process (pytest-xdist shares the cores)
torch.set_num_threads(1)

# the package re-exports a function of the same name: import the module itself
jfa = importlib.import_module("tpu_parallel.ops.flash_attention")
tfa = importlib.import_module("tpu_parallel_torch.ops.flash_attention")

NUM_RANKS = 8
OP_TOL = dict(rtol=1e-4, atol=1e-4)
CHUNK_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
TRAINER_KW = dict(model="tiny", global_batch_size=8, num_minibatches=2, steps=4,
                  warmup_steps=2)
LAYERS = 4


def _jmesh(**sizes):
    return jax_make_mesh(JMeshConfig(**sizes), devices=jax.devices()[:NUM_RANKS])


def _unbox(tree):
    import flax.linen as nn

    return jax.tree.map(lambda x: np.asarray(x.value if isinstance(x, nn.Partitioned) else x),
                        tree, is_leaf=lambda x: isinstance(x, nn.Partitioned))


# -- the inputs and JAX's references, each computed once -----------------------


@functools.lru_cache(maxsize=None)
def _op_inputs(name):
    _, (b, s, h, h_kv, d), _, packed, _, _ = SP_OP_CASES[name]
    rng = np.random.default_rng(sorted(SP_OP_CASES).index(name))
    out = {x: rng.standard_normal((b, s, n, d), dtype=np.float32)
           for x, n in (("q", h), ("k", h_kv), ("v", h_kv))}
    if packed:
        out["seg"] = np.asarray(make_packed_segments(jax.random.PRNGKey(11), b, s))
    return out


@functools.lru_cache(maxsize=None)
def _jax_op(name):
    """JAX's op of case ``name`` under ``shard_map`` on its mesh: the full
    output and, for gradient cases, d(sum(out^2)) by q, k, v."""
    op, (b, s, h, h_kv, d), kw, packed, grad, (data, seq) = SP_OP_CASES[name]
    x = _op_inputs(name)
    block = min(32, s // seq)
    if op == "ring":
        fn = functools.partial(jring.ring_attention, axis_name="seq", **kw)
    elif op == "ring_flash":
        fn = functools.partial(jring.ring_flash_attention, axis_name="seq", block_q=block,
                               block_k=block, interpret=True, **kw)
    else:
        fn = functools.partial(jax_ulysses, axis_name="seq", **kw)
    seg = jnp.asarray(x["seg"]) if packed else None
    spec = P(None, "seq")

    def run(q, k, v):
        if seg is None:
            body, args, specs = fn, (q, k, v), (spec,) * 3
        else:
            body = lambda q, k, v, sg: fn(q, k, v, segment_ids=sg)  # noqa: E731
            args, specs = (q, k, v, seg), (spec,) * 4
        return jax.shard_map(body, mesh=_jmesh(data=data, seq=seq), in_specs=specs,
                             out_specs=spec, check_vma=False)(*args)

    q, k, v = (jnp.asarray(x[n]) for n in "qkv")
    out = {"out": np.asarray(jax.jit(run)(q, k, v))}
    if grad:
        grads = jax.jit(jax.grad(lambda q, k, v: (run(q, k, v).astype(jnp.float32) ** 2).sum(),
                                 argnums=(0, 1, 2)))(q, k, v)
        out.update({f"d{n}": np.asarray(g) for n, g in zip("qkv", grads)})
    return out


@functools.lru_cache(maxsize=None)
def _jax_trainer(name):
    """JAX's Trainer on its seq mesh: its init, its example batch and 4
    steps' losses and final params (``tests/test_torch_tp.py``'s harness)."""
    overrides, sizes = SP_TRAINERS[name]
    trainer = JTrainer(JTrainerConfig(**TRAINER_KW, model_overrides=overrides,
                                      mesh=JMeshConfig(**sizes)), mesh=_jmesh(**sizes))
    state = trainer.init()
    params0 = _unbox(state.params)
    example = {k: np.asarray(v) for k, v in vars(trainer.example_batch).items() if v is not None}
    one_device = jax.tree.map(np.asarray, jax_export(state.params))
    losses = []
    for _ in range(4):
        state, metrics = trainer.funcs.step_fn(state, None, trainer.example_batch)
        losses.append(jax_compute(metrics)["loss"])
    return (params0, example, losses, _unbox(state.params), str(trainer.batch_spec),
            one_device)


TRAINER_3D_KW = dict(model="tiny", global_batch_size=8, steps=6, log_every=6,
                     learning_rate=1e-2, donate=False)


@functools.lru_cache(maxsize=None)
def _jax_trainer_3d():
    """``tests/test_train_lib.py::test_trainer_seq_parallel_ring``'s
    Trainer (data=2 x seq=2 x model=2): its init, batch, 6 steps' losses."""
    overrides, sizes = SP_TRAINER_3D
    trainer = JTrainer(JTrainerConfig(**TRAINER_3D_KW, model_overrides=overrides,
                                      mesh=JMeshConfig(**sizes)), mesh=_jmesh(**sizes))
    state = trainer.init()
    params0 = _unbox(state.params)
    example = {k: np.asarray(v) for k, v in vars(trainer.example_batch).items() if v is not None}
    losses = []
    for _ in range(6):
        state, metrics = trainer.funcs.step_fn(state, None, trainer.example_batch)
        losses.append(jax_compute(metrics)["loss"])
    return params0, example, losses, str(trainer.batch_spec), trainer.num_params


def _jax_one_device_losses(params, example, overrides, n_steps, **config):
    """JAX's Trainer step on one device, written out (the model on
    ``attn_impl="xla"``, ``make_gpt_loss``, the Trainer's optimizer): the
    loss of each of ``n_steps`` steps on ``example`` from ``params``."""
    import optax

    from tpu_parallel.core.state import TextBatch as JTextBatch
    from tpu_parallel.train_lib import make_optimizer

    model = JGPTLM(jax_tiny(**dict(overrides, attn_impl="xla")))
    loss_fn = jax_make_gpt_loss(model.config)
    tx = make_optimizer(JTrainerConfig(**config))
    batch = JTextBatch(**{k: jnp.asarray(v) for k, v in example.items()})

    @jax.jit
    def step(p, opt):
        loss, grads = jax.value_and_grad(
            lambda q: loss_fn(q, model.apply, batch, jax.random.PRNGKey(0))[0])(p)
        updates, opt = tx.update(grads, opt, p)
        return optax.apply_updates(p, updates), opt, loss

    params = jax.tree.map(jnp.asarray, params)
    opt, losses = tx.init(params), []
    for _ in range(n_steps):
        params, opt, loss = step(params, opt)
        losses.append(float(loss))
    return losses


def _variant_batch(name):
    batch = jax_lm_batch(jax.random.PRNGKey(0), 8, 64, 256)
    out = {k: np.asarray(v) for k, v in vars(batch).items() if v is not None}
    if name.endswith("packed"):
        out["segment_ids"] = np.asarray(make_packed_segments(jax.random.PRNGKey(2), 8, 64))
    return out


@functools.lru_cache(maxsize=None)
def _jax_variant(name):
    """One device, ``attn_impl="xla"``: the init, batch, loss and gradients
    of the global loss the seq-parallel run computes (each rank's local
    mean, averaged over data and seq: the global mean, every block holding
    as many tokens)."""
    from tpu_parallel.core.state import TextBatch as JTextBatch

    overrides, _ = SP_VARIANTS[name]
    cfg = jax_tiny(**dict(overrides, attn_impl="xla"))
    model = JGPTLM(cfg)
    b = _variant_batch(name)
    batch = JTextBatch(**{k: jnp.asarray(v) for k, v in b.items()})
    params = model.init({"params": jax.random.PRNGKey(42)}, batch.tokens, train=False)["params"]
    loss_fn = jax_make_gpt_loss(cfg)
    (loss, _), grads = jax.value_and_grad(
        lambda p: loss_fn(p, model.apply, batch, jax.random.PRNGKey(0)), has_aux=True)(params)
    return jax.tree.map(np.asarray, params), b, float(loss), jax.tree.map(np.asarray, grads)


def _loader_tokens():
    return np.random.default_rng(9).integers(0, 256, 64 * 40 + 1).astype(np.uint16)


def _make_inputs(outdir):
    inputs = {}
    for name in SP_OP_CASES:
        for key, value in _op_inputs(name).items():
            inputs[f"op_{name}/{key}"] = value
    for name in SP_TRAINERS:
        params0, example, _, _, _, _ = _jax_trainer(name)
        inputs.update(flat_tree(f"tparams_{name}", params0))
        inputs.update(flat_tree(f"example_{name}", example))
    params0, example, _, _, _ = _jax_trainer_3d()
    inputs.update(flat_tree("tparams_3d", params0))
    inputs.update(flat_tree("example_3d", example))
    for name in SP_VARIANTS:
        params, batch, _, _ = _jax_variant(name)
        inputs.update(flat_tree(f"vparams_{name}", params))
        inputs.update(flat_tree(f"vbatch_{name}", batch))
    inputs["loader_tokens"] = _loader_tokens()
    return inputs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_once("sp", tmp_path_factory, _make_inputs, num_ranks=NUM_RANKS)


def _check_op(ranks, name):
    """Each rank's seq block of case ``name`` against JAX's."""
    _, (_, s, _, _, _), _, _, grad, (_, seq) = SP_OP_CASES[name]
    want = _jax_op(name)
    n = s // seq
    coord = "seq_coord_42" if SP_OP_CASES[name][5] == (4, 2) else "seq_coord"
    for out in ranks:
        c = int(out[coord])
        blk = slice(c * n, (c + 1) * n)
        for key in ("out", "dq", "dk", "dv") if grad else ("out",):
            np.testing.assert_allclose(out[f"op_{name}/{key}"], want[key][:, blk], **OP_TOL,
                                       err_msg=f"{name} {key} (seq block {c})")


def _not_key(key, d_model, head_dim):
    """Every entry but the qkv bias's key slices (``tests/test_torch_tp.py``)."""
    if key.endswith("attn.qkv.bias"):
        return (np.arange(3 * d_model) % (3 * head_dim)) // head_dim != 1
    return slice(None)


def _check_grads(out, prefix, jax_grads, cfg):
    from tpu_parallel_torch.models.convert import params_from_jax

    want = params_from_jax(jax_grads, cfg)
    got = {k[len(prefix) + 1:]: v for k, v in out.items() if k.startswith(prefix + "/")}
    assert sorted(got) == sorted(want)
    for key, value in got.items():
        np.testing.assert_allclose(value, want[key].numpy(), **GRAD_TOL, err_msg=key)


# -- tests/test_ring_attention.py: the ops on data=2 x seq=4 ------------------


def test_ring_matches_reference(ranks):
    _check_op(ranks, "ring_plain")


def test_ring_gradients_match_reference(ranks):
    _check_op(ranks, "ring_plain_grad")


def test_ring_flash_matches_reference(ranks):
    _check_op(ranks, "ring_flash")


def test_ring_flash_gradients_match_ring(ranks):
    """JAX's flash ring's gradients (its chunk kernels' custom VJP with the
    lse cotangent) against the port's (the final out and lse per chunk)."""
    _check_op(ranks, "ring_flash_grad")


def test_ring_window_matches_masked_reference(ranks):
    for window in (16, 32, 100, 1000):  # < chunk, = chunk, cross-chunk, > seq
        _check_op(ranks, f"ring_plain_window{window}")


def test_ring_flash_window_matches_masked_reference(ranks):
    for window in (24, 100, 1000):  # local_s = 64: < chunk, two chunks, > seq
        _check_op(ranks, f"ring_flash_window{window}")


def test_ring_flash_window_gradients_match(ranks):
    _check_op(ranks, "ring_flash_window_grad")


@pytest.mark.parametrize("impl", ["plain", "flash"])
def test_ring_packed_matches_reference(ranks, impl):
    """Segment ids rotate with their K/V chunk: outputs and gradients."""
    _check_op(ranks, f"ring_{impl}_packed")


@pytest.mark.parametrize("impl", ["plain", "flash"])
def test_ring_gqa_matches_expanded_reference(ranks, impl):
    """GQA K/V ride the ring at kv-head width."""
    _check_op(ranks, f"ring_{impl}_gqa")


def test_ring_bidirectional_window_matches_dense(ranks):
    for window in (16, 32, 100, 1000):
        _check_op(ranks, f"ring_plain_bidir_window{window}")


def test_ring_flash_bidirectional_window_matches_dense(ranks):
    """Signed static offsets: chunks behind, on and ahead of the queries
    through the symmetric band; out-of-band chunks skipped."""
    for window in (24, 100, 1000):
        _check_op(ranks, f"ring_flash_bidir_window{window}")


def test_ring_flash_bidirectional_window_gradients(ranks):
    _check_op(ranks, "ring_flash_bidir_window_grad")


def test_ring_flash_bidirectional_packed_gradients(ranks):
    """The bidirectional flash ring without a window, on packed rows."""
    _check_op(ranks, "ring_flash_bidir_grad")


# -- the chunk wrapper and combine_chunks (one process) ------------------------


def _qkv(seed, b, s, h, d, s_q=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s_q or s, h, d), dtype=np.float32)
    k = rng.standard_normal((b, s, h, d), dtype=np.float32)
    v = rng.standard_normal((b, s, h, d), dtype=np.float32)
    return q, k, v


def test_chunk_attention_full_matches_reference():
    """Non-causal chunk == JAX's chunk kernel (out and lse)."""
    q, k, v = _qkv(0, 2, 128, 2, 32)
    out_j, lse_j = jfa.flash_chunk_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                             causal=False, block_q=64, block_k=64,
                                             interpret=True)
    out_t, lse_t = tfa.flash_chunk_attention(*map(torch.from_numpy, (q, k, v)), causal=False,
                                             block_q=64, block_k=64)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **CHUNK_TOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), **CHUNK_TOL)


def _two_halves(flash_chunk, combine, q, k, v):
    s = k.shape[1]
    o1, l1 = flash_chunk(q, k[:, :s // 2], v[:, :s // 2], causal=False, block_q=32,
                         block_k=32)
    o2, l2 = flash_chunk(q, k[:, s // 2:], v[:, s // 2:], causal=True, block_q=32, block_k=32)
    return combine(o1, l1, o2, l2)


def test_chunk_combine_equals_full_attention():
    """Two half-sequence partials combined: JAX's and the port's, out and
    lse."""
    q, k, v = _qkv(1, 1, 128, 2, 16, s_q=64)
    jchunk = functools.partial(jfa.flash_chunk_attention, interpret=True)
    jcomb = lambda o1, l1, o2, l2: jring.combine_chunks(  # noqa: E731
        o1.astype(jnp.float32), l1, o2.astype(jnp.float32), l2)
    out_j, lse_j = _two_halves(jchunk, jcomb, *map(jnp.asarray, (q, k, v)))
    out_t, lse_t = _two_halves(tfa.flash_chunk_attention, combine_chunks,
                               *map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **CHUNK_TOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), **CHUNK_TOL)


def test_chunk_combine_gradients():
    """Gradients through combine_chunks (the lse cotangent reaches the
    backward as dlse) against JAX's, for a loss of both outputs."""
    q, k, v = _qkv(2, 1, 64, 2, 16, s_q=32)

    def jloss(q, k, v):
        out, lse = _two_halves(functools.partial(jfa.flash_chunk_attention, interpret=True),
                               jring.combine_chunks, q, k, v)
        return jnp.sum(out ** 2) + 0.1 * jnp.sum(lse)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out, lse = _two_halves(tfa.flash_chunk_attention, combine_chunks, qt, kt, vt)
    ((out ** 2).sum() + 0.1 * lse.sum()).backward()
    for got, w, name in zip((qt.grad, kt.grad, vt.grad), want, "qkv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **CHUNK_TOL, err_msg=f"d{name}")


def test_chunk_attention_non_divisible_lengths():
    """JAX's exact-divisor tile shrink and its warning, for API parity."""
    q, k, v = _qkv(3, 1, 96, 2, 16)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out_t, _ = tfa.flash_chunk_attention(*map(torch.from_numpy, (q, k, v)), causal=False,
                                             block_q=64, block_k=64)
    assert any("shrank tiles to 32x32" in str(c.message) for c in caught)
    out_j, _ = jfa.flash_chunk_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         causal=False, block_q=64, block_k=64, interpret=True)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **CHUNK_TOL)


def test_chunk_attention_refusals():
    """JAX's refusals in its words: segment ids passed one-sided, heads
    that do not divide."""
    q = torch.zeros(1, 16, 3, 16)
    k = torch.zeros(1, 16, 2, 16)
    seg = torch.zeros(1, 16, dtype=torch.int32)
    with pytest.raises(ValueError, match="must be passed together"):
        tfa.flash_chunk_attention(q, q, q, causal=True, segment_ids_q=seg)
    with pytest.raises(ValueError, match="not a multiple of k/v heads"):
        tfa.flash_chunk_attention(q, k, k, causal=True)


def test_combine_chunks_empty_partials():
    """An empty partial (lse NEG_INF, out 0) gets weight 0, as in JAX's
    combine; a row empty in both stays empty with out 0 (JAX's XLA flushes
    its 1e-38 floor to zero there and gives 0/0, which its ring never
    reads: its first partial is the diagonal, never empty); gradients stay
    finite, 0 on the empty side."""
    rng = np.random.default_rng(4)
    out_a = rng.standard_normal((1, 4, 2, 8)).astype(np.float32)
    lse_a = rng.standard_normal((1, 2, 4)).astype(np.float32)
    out_b = rng.standard_normal((1, 4, 2, 8)).astype(np.float32)
    lse_b = rng.standard_normal((1, 2, 4)).astype(np.float32)
    lse_b[:, :, :2] = NEG_INF
    out_b[:, :2] = 0.0
    lse_a[:, :, 0] = NEG_INF
    out_a[:, 0] = 0.0
    got = combine_chunks(*map(torch.from_numpy, (out_a, lse_a, out_b, lse_b)))
    want = jring.combine_chunks(*map(jnp.asarray, (out_a, lse_a, out_b, lse_b)))
    np.testing.assert_allclose(got[0][:, 1:].numpy(), np.asarray(want[0])[:, 1:], rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-6, atol=1e-6)
    assert (got[1][:, :, 0] == NEG_INF).all() and (got[0][:, 0] == 0).all()
    np.testing.assert_allclose(got[0][:, 1].numpy(), out_a[:, 1], rtol=1e-6)
    ts = [torch.from_numpy(x).requires_grad_() for x in (out_a, lse_a, out_b, lse_b)]
    o, lse = combine_chunks(*ts)
    ((o ** 2).sum() + torch.where(lse > NEG_INF / 2, lse, 0.0).sum()).backward()
    assert all(torch.isfinite(t.grad).all() for t in ts)
    assert (ts[3].grad[:, :, :2] == 0).all()


# -- tests/test_ulysses.py ------------------------------------------------------


def test_ulysses_matches_reference(ranks):
    _check_op(ranks, "ulysses")


def test_ulysses_gradients_match_reference(ranks):
    _check_op(ranks, "ulysses_grad")


def test_ulysses_rejects_indivisible_heads(ranks):
    for out in ranks:
        assert str(out["ulysses_indivisible"]) == "n_heads=3 not divisible by seq axis size 4"


@pytest.mark.parametrize("h_kv", [2, 4])
def test_ulysses_gqa_matches_expanded_reference(ranks, h_kv):
    """kv heads reshard at kv width when the axis divides them (4), else
    expand inside the op (2): outputs and gradients."""
    _check_op(ranks, f"ulysses_gqa{h_kv}")


# -- the Trainer over a seq axis ------------------------------------------------


@pytest.mark.parametrize("name", sorted(SP_TRAINERS))
def test_gpt_seq_parallel_trainer_matches_jax(ranks, name):
    """``tests/test_ring_attention.py::test_gpt_ring_attention_training``
    and ``tests/test_ulysses.py::test_gpt_ulysses_attention_training`` as
    parity: JAX's Trainer over data=2 x seq=4 and the port's from its init,
    4 steps on its example batch (each rank its rows' seq block): losses,
    final masters, under both remat policies; every rank equal."""
    from tpu_parallel_torch.models import tiny_test
    from tpu_parallel_torch.models.convert import params_from_jax

    _, _, losses, final, spec, _ = _jax_trainer(name)
    cfg = tiny_test(**SP_TRAINERS[name][0])
    want = params_from_jax(final, cfg)
    assert spec == "PartitionSpec('data', 'seq')"
    for out in ranks:
        assert tuple(out[f"trainer_{name}_batch_spec"]) == ("data", "seq")
        for policy in ("full", "proj_attn"):
            np.testing.assert_allclose(out[f"trainer_{name}_{policy}_losses"], losses, rtol=1e-5)
            for key, value in want.items():
                got = out[f"trainer_{name}_{policy}/{key}"]
                keep = _not_key(key, cfg.d_model, cfg.head_dim)
                np.testing.assert_allclose(got[keep], value.numpy()[keep], rtol=1e-4, atol=1e-5,
                                           err_msg=f"{name} {policy} {key}")
    assert all(np.array_equal(out[f"trainer_{name}_full_losses"],
                              ranks[0][f"trainer_{name}_full_losses"]) for out in ranks)


@pytest.mark.parametrize("name", sorted(SP_TRAINERS))
def test_seq_parallel_gradients_match_one_device(ranks, name):
    """The step-1 synced gradients (each rank's local mean loss, averaged
    over data and seq in one all-reduce) against JAX's gradients of the
    global mean loss on one device: AdamW would hide a wrong scale."""
    from tpu_parallel.core.state import TextBatch as JTextBatch
    from tpu_parallel_torch.models import tiny_test

    _, example, _, _, _, params0 = _jax_trainer(name)
    overrides = SP_TRAINERS[name][0]
    cfg = jax_tiny(**dict(overrides, attn_impl="xla"))
    model = JGPTLM(cfg)
    batch = JTextBatch(**{k: jnp.asarray(v) for k, v in example.items()})
    loss_fn = jax_make_gpt_loss(cfg)
    grads = jax.grad(lambda p: loss_fn(p, model.apply, batch, jax.random.PRNGKey(0))[0])(
        params0)
    for out in ranks:
        _check_grads(out, f"trainer_{name}_grads", jax.tree.map(np.asarray, grads),
                     tiny_test(**overrides))


def test_collectives_per_step(ranks):
    """Per step of ``tiny`` (4 layers, 2 minibatches) over data=2 x seq=4:
    one gradient all-reduce over the joint data x seq ranks.  The plain
    ring (CPU) shifts K and V 3 times per layer in the forward, again in
    the recompute and once each in the backward: 18 sends per layer and
    minibatch under either policy (its many ops are not kept).  Ulysses
    runs 4 all-to-alls per layer in the forward, 4 in the backward and,
    under ``"full"``, 4 in the recompute (``"proj_attn"`` keeps their
    outputs)."""
    per = lambda n: 2 * LAYERS * n  # noqa: E731
    for out in ranks:
        for policy in ("full", "proj_attn"):
            ring = out[f"trainer_ring_{policy}_counts"]
            assert ring.tolist() == [[1, per(18), per(18), 0]] * 4, (policy, ring)
            a2a = per(12 if policy == "full" else 8)
            assert out[f"trainer_ulysses_{policy}_counts"].tolist() == [[1, 0, 0, a2a]] * 4


def test_token_axes_share_one_group(ranks):
    """``make_mesh`` makes the data and seq axes' joint group with the
    mesh: an all-reduce over data, seq and model runs on it alone over
    data=2 x seq=4, and on it and then the model axis over data=2 x seq=2 x
    model=2."""
    for out in ranks:
        assert out["token_group_sizes"].tolist() == [8]
        assert out["token_group_sizes_3d"].tolist() == [4, 2]


def test_flash_ring_in_model_matches_plain_ring(ranks):
    """The flash-composed ring in the model (the CUDA dispatch, run here on
    the kernels' plain versions): the plain ring's losses.  Per layer and
    minibatch it sends K and V (one buffer) 3 times in the forward and
    K, V with their gradients 3 times plus the gradients home once in the
    backward; under ``"proj_attn"`` the recompute keeps the ring's output
    (its forward op counts as ``"attn"``) and sends nothing, under
    ``"full"`` it replays the 3 forward sends."""
    for out in ranks:
        for policy, sends in (("full", 10), ("proj_attn", 7)):
            np.testing.assert_allclose(out[f"ring_flash_model_{policy}_losses"],
                                       out[f"trainer_ring_{policy}_losses"][:2], rtol=1e-5)
            n = 2 * LAYERS * sends
            assert out[f"ring_flash_model_{policy}_counts"].tolist() == [[1, n, n, 0]] * 2


def test_trainer_seq_parallel_ring(ranks):
    """``tests/test_train_lib.py::test_trainer_seq_parallel_ring``: a
    Trainer over data=2 x seq=2 x model=2 with ring attention, from JAX's
    init: 6 steps' losses (lr 1e-2) equal JAX's Trainer step on one device
    from that init, the first two (lr 0, then 1e-3) JAX's own 3-D
    Trainer's (which leaves its one-device run by 1e-3 after step 4 at
    this lr: ROADMAP §C); ``batch_spec`` ``("data", "seq")``;
    ``num_params`` without tracing the ring; ``train`` runs.  Per step the
    sync is one all-reduce over data x seq and one over model for the
    replicated leaves, one over data x seq for the model shards."""
    from tpu_parallel_torch.models import tiny_test
    from tpu_parallel_torch.models.convert import params_from_jax, params_to_jax

    params0, example, losses, spec, num_params = _jax_trainer_3d()
    overrides = SP_TRAINER_3D[0]
    dense = params_to_jax(params_from_jax(params0, tiny_test(**overrides)),
                          tiny_test(**overrides))
    one_device = _jax_one_device_losses(jax.tree.map(np.asarray, dense), example,
                                        overrides, 6, **TRAINER_3D_KW)
    assert spec == "PartitionSpec('data', 'seq')"
    for out in ranks:
        np.testing.assert_allclose(out["trainer_3d_losses"], one_device, rtol=1e-5)
        np.testing.assert_allclose(out["trainer_3d_losses"][:2], losses[:2], rtol=1e-5)
        assert tuple(out["trainer_3d_batch_spec"]) == ("data", "seq")
        assert int(out["trainer_3d_num_params"]) > 0
        assert num_params > 0
        loss, accuracy = out["trainer_3d_train"]
        assert 0 < loss < losses[-1] * 1.5 and accuracy >= 0
        # 2 seq ranks: one rotation of K and V per layer, forward,
        # recompute and backward
        assert out["trainer_3d_counts"].tolist() == [[3, 6 * LAYERS, 6 * LAYERS, 0]] * 6


def test_trainer_rejects_seq_mesh_with_dense_attention(ranks):
    with pytest.raises(ValueError, match="attn_impl") as want:
        JTrainer(JTrainerConfig(model="tiny", mesh=JMeshConfig(data=4, seq=2),
                                global_batch_size=8), mesh=_jmesh(data=4, seq=2))
    for out in ranks:
        assert str(out["dense_refusal"]) == str(want.value)


@pytest.mark.parametrize("name", sorted(SP_VARIANTS))
def test_gpt_seq_parallel_variant_training(ranks, name):
    """The windowed, packed and GQA cases of ``tests/test_ring_attention.py``
    and ``tests/test_ulysses.py`` (Ulysses' window over data=4 x seq=2):
    the step-1 loss and synced gradients against JAX's on one device, then
    a falling loss over the global batch's tokens."""
    from tpu_parallel_torch.models import tiny_test

    _, _, loss, grads = _jax_variant(name)
    for out in ranks:
        losses = out[f"variant_{name}_losses"]
        np.testing.assert_allclose(losses[0], loss, rtol=1e-5)
        assert losses[-1] < losses[0] and len(losses) == SP_VARIANT_STEPS
        assert float(out[f"variant_{name}_tokens"]) == 8 * 64
        _check_grads(out, f"variant_{name}_grads", grads, tiny_test(**SP_VARIANTS[name][0]))


def test_bare_forward_looks_up_its_block_of_positions(ranks):
    """A forward without positions on seq rank c embeds rows ``16 c ...
    16 c + 15`` of the position table: its logits are JAX's one-device
    logits of those tokens."""
    params, batch, _, _ = _jax_variant("ring_packed")
    model = JGPTLM(jax_tiny(seq_len=64))
    want = np.asarray(model.apply({"params": params}, jnp.asarray(batch["tokens"]), train=False))
    for out in ranks:
        c = int(out["seq_coord"])
        np.testing.assert_allclose(out["bare_logits"], want[:, 16 * c:16 * c + 16], rtol=1e-4,
                                   atol=1e-5)


def test_decode_refuses_sequence_parallelism(ranks):
    for out in ranks:
        assert str(out["decode_refusal"]) == "incremental decoding under sequence parallelism"


def test_loader_hands_each_rank_its_seq_block(ranks):
    """Data rank ``p`` holds rows ``p::2`` of each of JAX's one-process
    global batches (``tests/test_torch_dp.py``'s rule) and seq rank ``c``
    their tokens, targets and global positions ``16 c ... 16 c + 15``; the
    view stitched over data x seq (``make_global_batch(..., ("data",
    "seq"))``) is the ranks' rows in device order, whole rows."""
    ds = JTokenDataset(_loader_tokens(), 64)
    ref = JDataLoader(ds, jax_make_mesh(JMeshConfig(data=1), devices=jax.devices()[:1]), 8,
                      seed=3)
    for step in range(2):
        epoch, b = divmod(step, ref.batches_per_epoch)
        rows = (ref._epoch_order(epoch) + ref._window_offset)[b * 8:(b + 1) * 8]
        stitched = ds.batch(np.concatenate([rows[p::2] for p in range(2)]))
        for r, out in enumerate(ranks):
            p, c = r // 4, int(out["seq_coord"])
            local = ds.batch(rows[p::2])
            for field in ("tokens", "targets", "positions"):
                np.testing.assert_array_equal(out[f"loader_{step}_{field}"],
                                              np.asarray(getattr(stitched, field)))
                np.testing.assert_array_equal(out[f"loader_{step}_local_{field}"],
                                              np.asarray(getattr(local, field))[:, 16 * c:16 * c + 16])
