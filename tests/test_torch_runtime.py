"""Port parity: the runtime (``runtime/``: ``MeshConfig``, ``factor_mesh``,
``make_mesh``, ``initialize``, ``process_info``), ``core/rng.py``,
``core/metrics.sync_metrics`` and ``core/optim.global_norm_sharded``
against the JAX package.

The multi-rank cases run once, in one 4-rank gloo group of CPU processes
(``tests/torch_dp_worker.py``, suite ``runtime``), and are held to JAX's
``MeshConfig(data=4)`` mesh on four of the suite's simulated devices:
``tests/test_core.py:83-108``'s and ``tests/test_optim.py:13-58``'s
contracts.  Norms within rtol 1e-6 (fp32 sums in another order), the clip
factor bitwise equal across ranks.  JAX is imported inside the ``jx``
fixture, so the ``gpu`` case runs on the card without it.
"""

import json
import socket
import types

import numpy as np
import pytest
import torch
from torch_dp_worker import NUM_RANKS, run_once

from tpu_parallel_torch.core.optim import ClipByGlobalNormSharded, global_norm_sharded
from tpu_parallel_torch.core.rng import fold_rng_over_axis, split_rng_like
from tpu_parallel_torch.runtime import (AXIS_ORDER, MeshConfig, factor_mesh, initialize,
                                        make_mesh, process_info)

# one torch intra-op thread per test process (pytest-xdist shares the cores)
torch.set_num_threads(1)

SHAPES = [dict(), dict(data=2), dict(data=-1, model=2), dict(data=2, model=2),
          dict(pipe=2, data=-1), dict(data=-1, seq=3), dict(data=-1, model=-1),
          dict(data=3, model=2, pipe=1, seq=1), dict(data=0), dict(model=-1, data=2)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_once("runtime", tmp_path_factory, lambda outdir: {"seed": np.zeros(1)})


@pytest.fixture(scope="module")
def jx():
    """The JAX side: ``jax``, ``jnp``, ``P`` and the JAX runtime's
    ``MeshConfig``, ``factor_mesh``, ``make_mesh``, ``process_info``, and a
    data=4 mesh on four simulated devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec

    from tpu_parallel import runtime

    return types.SimpleNamespace(
        jax=jax, jnp=jnp, P=PartitionSpec, MeshConfig=runtime.MeshConfig,
        factor_mesh=runtime.factor_mesh, make_mesh=runtime.make_mesh,
        process_info=runtime.process_info,
        mesh4=runtime.make_mesh(runtime.MeshConfig(data=4), devices=jax.devices()[:NUM_RANKS]))


def _resolve(cls, shape, n):
    try:
        return dataclass_tuple(cls(**shape).resolved(n))
    except ValueError as exc:
        return str(exc)


def dataclass_tuple(cfg):
    return (cfg.data, cfg.model, cfg.pipe, cfg.seq, tuple(cfg.axis_sizes().items()))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 12, 16])
def test_mesh_config_and_factor_mesh_match_jax(jx, n):
    """``MeshConfig.resolved`` (values and error messages) and
    ``factor_mesh`` equal JAX's over shapes and device counts."""
    for shape in SHAPES:
        assert _resolve(MeshConfig, shape, n) == _resolve(jx.MeshConfig, shape, n), shape
    for want in [(1, 1, 1), (2, 1, 1), (3, 2, 1), (4, 4, 2), (8, 1, 1), (1, 3, 5)]:
        kw = dict(want_model=want[0], want_pipe=want[1], want_seq=want[2])
        assert dataclass_tuple(factor_mesh(n, **kw)) == dataclass_tuple(jx.factor_mesh(n, **kw))


def test_mesh_without_a_group_is_one_device(jx):
    """No process group: a config resolving to one device is the
    single-device case (``None``); others raise JAX's error for one device."""
    assert not torch.distributed.is_initialized()
    assert make_mesh() is None and make_mesh(MeshConfig(data=1, model=1)) is None
    one = jx.jax.devices()[:1]
    for shape in (dict(data=2), dict(data=-1, model=3)):
        with pytest.raises(ValueError) as want:
            jx.make_mesh(jx.MeshConfig(**shape), devices=one)
        with pytest.raises(ValueError) as got:
            make_mesh(MeshConfig(**shape))
        assert str(got.value) == str(want.value)


def test_make_mesh_on_the_group(ranks, jx):
    """Four named axes in ``AXIS_ORDER``, size-1 axes kept; the data axis's
    ranks for ``data=4`` and for ``data=2, model=2`` are JAX's device ids
    along that axis; its errors are JAX's for four devices."""
    jmesh22 = jx.make_mesh(jx.MeshConfig(data=2, model=2), devices=jx.jax.devices()[:NUM_RANKS])
    ids = np.vectorize(lambda d: d.id)(jmesh22.devices)
    for rank, out in enumerate(ranks):
        assert tuple(out["mesh_names"]) == AXIS_ORDER
        assert tuple(out["mesh_shape"]) == (1, 4, 1, 1) == tuple(out["mesh_wild_shape"])
        assert out["mesh_data_ranks"].tolist() == [0, 1, 2, 3]
        assert int(out["mesh_data_coord"]) == rank
        assert tuple(out["mesh22_shape"]) == tuple(jmesh22.devices.shape) == (1, 2, 1, 2)
        p, d, s, m = (int(i[0]) for i in np.nonzero(ids == rank))
        assert out["mesh22_data_ranks"].tolist() == ids[p, :, s, m].tolist()
        assert out["mesh22_model_ranks"].tolist() == ids[p, d, s, :].tolist()
        for name, shape in (("cover", dict(data=3)), ("wild", dict(data=-1, model=3)),
                            ("two_wild", dict(data=-1, model=-1))):
            with pytest.raises(ValueError) as want:
                jx.MeshConfig(**shape).resolved(NUM_RANKS)
            assert str(out[f"mesh_error_{name}"]) == str(want.value)


def test_initialize_without_environment_is_a_noop(jx, monkeypatch):
    """No torchrun environment and no arguments: no group is made, and
    ``process_info`` has JAX's keys plus ``backend``."""
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    initialize()
    assert not torch.distributed.is_initialized()
    info = process_info()
    assert set(info) == set(jx.process_info()) | {"backend"}
    assert (info["process_index"], info["process_count"], info["backend"]) == (0, 1, None)
    assert info["global_device_count"] == info["local_device_count"] == 1


def test_process_info_in_the_group(ranks, jx):
    for rank, out in enumerate(ranks):
        info = json.loads(str(out["info"]))
        assert set(info) == set(jx.process_info()) | {"backend"}
        assert info == dict(process_index=rank, process_count=4, local_device_count=1,
                            global_device_count=4, platform="cpu", backend="gloo")
        assert bool(out["simulated"])


def test_fold_rng_over_axis(ranks):
    """Four distinct per-rank draws (``tests/test_core.py:83-95``), equal
    across two runs; the replicated generator advances alike on every
    rank; an unbound axis (or no mesh) returns the generator itself."""
    draws = [tuple(out["fold_draw"].tolist()) for out in ranks]
    assert len(set(draws)) == NUM_RANKS
    assert len({tuple(out["fold_draw_22"].tolist()) for out in ranks}) == NUM_RANKS
    for out in ranks:
        np.testing.assert_array_equal(out["fold_draw"], out["fold_draw_again"])
        np.testing.assert_array_equal(out["fold_replicated_next"],
                                      ranks[0]["fold_replicated_next"])
        assert bool(out["fold_unbound_is_identity"])


def test_fold_rng_without_a_mesh_draws_nothing():
    gen = torch.Generator().manual_seed(5)
    before = gen.get_state()
    assert fold_rng_over_axis(gen, ("data", "model")) is gen
    assert torch.equal(gen.get_state(), before)


def test_split_rng_like():
    tree = {"a": torch.zeros(2), "b": [torch.zeros(1), torch.zeros(3)]}
    one = split_rng_like(torch.Generator().manual_seed(1), tree)
    two = split_rng_like(torch.Generator().manual_seed(1), tree)
    leaves = [one["a"], *one["b"]]
    draws = [torch.randn(2, generator=g).tolist() for g in leaves]
    assert len({tuple(d) for d in draws}) == 3
    assert draws == [torch.randn(2, generator=g).tolist() for g in [two["a"], *two["b"]]]


def _jax_sync(jx):
    from tpu_parallel.core.metrics import metric, sync_metrics

    jax, jnp, P = jx.jax, jx.jnp, jx.P

    def body(x):
        m = {"loss": metric(x.sum(), x.shape[0]), "rep": metric(2.0, 1)}
        acc = {"acc": metric(jax.lax.axis_index("data").astype(jnp.float32), 1)}
        return sync_metrics(m, "data"), sync_metrics(acc, (), mean_axes="data")

    f = jax.jit(jax.shard_map(body, mesh=jx.mesh4, in_specs=P("data"), out_specs=P()))
    return jax.tree.map(np.asarray, f(jnp.arange(16.0)))


def test_sync_metrics(ranks, jx):
    """``arange(16)`` over 4 ranks gives loss 7.5 (``tests/test_core.py:
    97-108``); a mean axis averages; a replicated metric summed over the
    axis multiplies by its size (``pvary_missing``'s contract); every value
    equals JAX's on its data=4 mesh.  Unbound axes are no-ops."""
    (summed, meaned) = _jax_sync(jx)
    for out in ranks:
        assert float(out["sync_loss"]) == pytest.approx(7.5)
        np.testing.assert_array_equal(out["sync_rep"], [float(x) for x in summed["rep"]])
        assert out["sync_rep"].tolist() == [8.0, 4.0]
        np.testing.assert_array_equal(out["sync_mean"], [float(x) for x in meaned["acc"]])
        assert bool(out["sync_unbound_is_identity"])


def _jax_optim(jx):
    import flax.linen as nn

    from tpu_parallel.core.optim import clip_by_global_norm_sharded, global_norm_sharded as jgn

    jax, jnp, P = jx.jax, jx.jnp, jx.P

    def norm_body():
        idx = jax.lax.axis_index("data").astype(jnp.float32)
        grads = {"sharded": nn.Partitioned(jnp.full((2,), idx), names=("data",)),
                 "replicated": jnp.ones((3,))}
        return jgn(grads)[None]

    def clip_body():
        idx = jax.lax.axis_index("data").astype(jnp.float32)
        grads = {"sharded": nn.Partitioned(jnp.full((4,), idx + 1.0), names=("data",)),
                 "replicated": jnp.full((4,), 2.0)}
        clipped, _ = clip_by_global_norm_sharded(1.0).update(grads, None)
        return clipped["replicated"][None], clipped["sharded"].value

    def smap(body, out_specs):
        return jax.jit(jax.shard_map(body, mesh=jx.mesh4, in_specs=(), out_specs=out_specs,
                                     check_vma=False))()

    norms = np.asarray(smap(norm_body, P("data")))
    replicated, sharded = smap(clip_body, (P("data"), P("data")))
    return norms, np.asarray(replicated), np.asarray(sharded)


def test_global_norm_sharded_and_clip(ranks, jx):
    """``DTensor`` ``Shard(0)`` leaves count every rank's shard once: the
    norm is the full tree's and JAX's; the clip factor is bitwise equal on
    every rank, and the clipped leaves equal JAX's."""
    norms, replicated, sharded = _jax_optim(jx)
    full = torch.cat([torch.arange(4.0).repeat_interleave(2), torch.ones(3)])
    want = float(full.norm())
    assert want == pytest.approx(np.sqrt(2 * (0 + 1 + 4 + 9) + 3.0), rel=1e-6)
    for out in ranks:
        np.testing.assert_allclose(float(out["norm"]), want, rtol=1e-6)
        np.testing.assert_allclose(float(out["norm"]), norms[0], rtol=1e-6)
        np.testing.assert_array_equal(out["clip_replicated"], ranks[0]["clip_replicated"])
        np.testing.assert_allclose(out["clip_replicated"], replicated[0], rtol=1e-6)
        np.testing.assert_allclose(out["clip_sharded_full"], sharded, rtol=1e-6)
        assert np.all(np.abs(out["clip_replicated"]) < 2.0)


def test_sharded_clip_without_shards_is_optax_clip():
    """On plain tensors: the norm of the whole tree, no collective, and
    optax's factor min(1, max_norm / max(norm, 1e-9)) on every leaf."""
    gen = torch.Generator().manual_seed(0)
    tree = {f"w{i}": torch.randn(17 * (i + 1), generator=gen) * 3 for i in range(5)}
    whole = torch.cat(list(tree.values()))
    np.testing.assert_allclose(float(global_norm_sharded(tree)), float(whole.norm()), rtol=1e-6)
    for max_norm in (1.0, 1e3):
        clipped, _ = ClipByGlobalNormSharded(max_norm).update(
            {k: v.clone() for k, v in tree.items()}, None)
        factor = min(1.0, max_norm / max(float(whole.norm()), 1e-9))
        for k, v in tree.items():
            np.testing.assert_allclose(clipped[k].numpy(), (v * factor).numpy(), rtol=1e-6)


@pytest.mark.gpu
def test_nccl_world_of_one_syncs_once_per_step(monkeypatch):
    """On the card, under torchrun's environment for one process: an NCCL
    group, ``"cuda"`` is ``cuda:0``, and a data-parallel ``Trainer`` step
    launches one gradient all-reduce and gives the step without a group."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.distributed as dist

    from tpu_parallel_torch.core.metrics import compute
    from tpu_parallel_torch.parallel import dp
    from tpu_parallel_torch.train_lib import Trainer, TrainerConfig

    config = TrainerConfig(model="tiny", global_batch_size=4, num_minibatches=2, steps=2,
                           warmup_steps=1)
    alone = Trainer(config)
    alone.init()
    want = [compute(alone.step_fn(alone.state, None, alone.example_batch)[1])["loss"]
            for _ in range(2)]
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    for name, value in dict(WORLD_SIZE="1", RANK="0", LOCAL_RANK="0",
                            MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)).items():
        monkeypatch.setenv(name, value)
    initialize()
    try:
        assert process_info()["backend"] == "nccl" and process_info()["platform"] == "gpu"
        trainer = Trainer(config)
        assert trainer.mesh is not None and trainer.device == torch.device("cuda", 0)
        trainer.init()
        before = dp.dp_allreduce_launches
        got = [compute(trainer.step_fn(trainer.state, None, trainer.example_batch)[1])["loss"]
               for _ in range(2)]
        assert dp.dp_allreduce_launches - before == 2
        np.testing.assert_allclose(got, want, rtol=1e-5)
    finally:
        dist.destroy_process_group()


def test_sync_gradients_is_pmean(ranks):
    """``sync_gradients_dp`` averages over the data axis (JAX's ``pmean``):
    separate tensors through a flattened copy, views of one flat buffer in
    place, one all-reduce each."""
    for out in ranks:
        np.testing.assert_array_equal(out["sync_grads_separate"], [1.5] * 3 + [3.0] * 4)
        np.testing.assert_array_equal(out["sync_grads_flat"], [1.5] * 7)
        assert int(out["sync_grads_launches"]) == 2
