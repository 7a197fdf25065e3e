"""Port parity: pipeline parallelism (``parallel/pp.py``: GPipe, the
interleaved schedule, 1F1B and the decode ring; the stage-owned GPT over a
pipe axis, its gradient sync, checkpoints, bridge and ``generate_sharded``;
the Trainer and the CLI on ``tiny_3d_cpu``) against the JAX package.

The multi-rank cases run once, in one 8-rank gloo group of CPU processes
(``tests/torch_dp_worker.py``, suite ``pp``), on JAX's own meshes: ``data=2,
pipe=4`` (``mesh_pipe4_data2``), ``data=2, model=2, pipe=2``
(``mesh_2x2x2``) and ``data=4, pipe=2``; JAX runs on the same meshes over
the test run's eight simulated devices, and the port starts from JAX's
inits (bridged with ``params_from_jax``) and numpy inputs.  Tolerances
(fp32), as the JAX tests state them (``tests/test_pp.py``): the pipelined
forward against sequential rtol 1e-4, atol 1e-5; gradients rtol 2e-4,
atol 1e-6 (interleaved) and rtol 1e-5, atol 1e-6 (1F1B against GPipe);
packed against unpacked 2e-4; leakage 1e-6; the Trainer's losses rtol 1e-5
(``tests/test_torch_tp.py``); greedy tokens exactly.  The synced TP x PP
gradients against one process's dense ones: rtol 1e-4, atol 1e-6
(``tests/test_tp.py``).
"""

import functools
import os
import subprocess
import sys

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch_dp_worker import flat_tree, run_once

from tpu_parallel.core import compute as jax_compute
from tpu_parallel.models import GPTLM as JGPTLM
from tpu_parallel.models import gpt as jgpt
from tpu_parallel.models.generate import generate_sharded as jax_generate_sharded
from tpu_parallel.parallel import fsdp as jfsdp
from tpu_parallel.runtime import MeshConfig as JMeshConfig
from tpu_parallel.runtime import make_mesh as jax_make_mesh
from tpu_parallel.train_lib import Trainer as JTrainer
from tpu_parallel.train_lib import TrainerConfig as JTrainerConfig
from tpu_parallel_torch.configs import get_config
from tpu_parallel_torch.models import GPTLM, tiny_test
from tpu_parallel_torch.models.convert import params_from_jax, params_to_jax
from tpu_parallel_torch.models.gpt import gpt2_350m, make_gpt_1f1b_grad_fn, stage_layers
from tpu_parallel_torch.parallel import pp

# one torch intra-op thread per test process (pytest-xdist shares the cores)
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM_RANKS = 8


def _unbox(tree):
    return jax.tree.map(lambda x: np.asarray(x.value if isinstance(x, nn.Partitioned) else x),
                        tree, is_leaf=lambda x: isinstance(x, nn.Partitioned))


def _jmesh(**sizes):
    return jax_make_mesh(JMeshConfig(**sizes), devices=jax.devices()[:NUM_RANKS])


def _batch(seed, rows):
    toks = np.random.default_rng(seed).integers(0, 256, (rows, 32)).astype(np.int32)
    return {"tokens": toks, "targets": np.roll(toks, -1, 1)}


def _shard_init(model, mesh, tokens):
    """JAX's PP init under ``shard_map`` (``tests/test_pp.py``'s probe):
    the params and their specs."""
    def init(r, t):
        return model.init({"params": r}, t, train=False)["params"]

    rng = jax.random.PRNGKey(42)
    probe = jax.shard_map(init, mesh=mesh, in_specs=(P(), P("data")), out_specs=P(),
                          check_vma=False)
    specs = nn.get_partition_spec(jax.eval_shape(probe, rng, tokens))
    params = jax.jit(jax.shard_map(init, mesh=mesh, in_specs=(P(), P("data")),
                                   out_specs=specs, check_vma=False))(rng, tokens)
    return params, specs


# -- the JAX references, each computed once ----------------------------------


@functools.lru_cache(maxsize=None)
def _jax_3d():
    """``tests/test_train_lib.py::test_trainer_tiny_3d``: JAX's Trainer on
    data=2 x model=2 x pipe=2, its init (the pipe and mesh layout), its
    example batch and 4 steps' losses; and greedy ``generate_sharded`` on
    that init (``tests/test_generate.py:453``)."""
    trainer = JTrainer(JTrainerConfig(model="tiny", model_overrides=dict(num_microbatches=2),
                                      mesh=JMeshConfig(data=2, model=2, pipe=2),
                                      global_batch_size=16, steps=4, log_every=1, donate=False),
                       mesh=_jmesh(data=2, model=2, pipe=2))
    state = trainer.init()
    params0 = _unbox(state.params)
    example = {k: np.asarray(v) for k, v in vars(trainer.example_batch).items() if v is not None}
    model = JGPTLM(jgpt.tiny_test(dtype=jnp.float32, remat=False, pipe_size=2))
    prompt, mask = _gen_prompt()
    tokens = jax_generate_sharded(model, state.params, jnp.asarray(prompt), trainer.mesh,
                                  max_new_tokens=8, prompt_mask=jnp.asarray(mask))
    losses = []
    for _ in range(4):
        state, metrics = trainer.funcs.step_fn(state, None, trainer.example_batch)
        losses.append(jax_compute(metrics)["loss"])
    return params0, example, losses, np.asarray(tokens)


@functools.lru_cache(maxsize=None)
def _jax_gpipe():
    """JAX's GPipe on data=2 x pipe=4 (``tests/test_pp.py:527``'s
    ``g_gpipe``): its init and the gradients synced over data and summed
    over pipe, on an 8-row batch."""
    from tpu_parallel.core.state import TextBatch as JTextBatch

    mesh = _jmesh(data=2, pipe=4)
    cfg = jgpt.tiny_test(pipe_size=4, num_microbatches=4, dtype=jnp.float32, remat=False)
    model = JGPTLM(cfg)
    loss_fn = jgpt.make_gpt_loss(cfg)
    b = _batch(7, 8)
    params, specs = _shard_init(model, mesh, jnp.asarray(b["tokens"]))
    batch = JTextBatch(tokens=jnp.asarray(b["tokens"]), targets=jnp.asarray(b["targets"]))

    def grads(p, bt, r):
        g, metrics = jax.grad(lambda q: loss_fn(q, model.apply, bt, r), has_aux=True)(p)
        g = jfsdp.sync_gradients(g, ("data",), psum_axes=("pipe",))
        loss = jax.lax.psum(metrics["loss"][0], ("data", "pipe"))
        return g, loss

    g, loss = jax.jit(jax.shard_map(grads, mesh=mesh, in_specs=(specs, P("data"), P()),
                                    out_specs=(specs, P()), check_vma=False))(
        params, batch, jax.random.PRNGKey(7))
    return _unbox(params), b, _unbox(g), float(loss)


@functools.lru_cache(maxsize=None)
def _jax_interleaved():
    """JAX's interleaved init (pipe=2 x 2 virtual stages on data=4), and the
    gradients of the one-stage twin on the same weights
    (``tests/test_pp.py:243``): the mean loss over the batch."""
    from tpu_parallel.core.state import TextBatch as JTextBatch

    mesh = _jmesh(data=4, pipe=2)
    cfg = jgpt.tiny_test(pipe_size=2, pipe_interleave=2, num_microbatches=2,
                         dtype=jnp.float32, remat=False)
    b = _batch(7, 8)
    params, _ = _shard_init(JGPTLM(cfg), mesh, jnp.asarray(b["tokens"]))
    tree = _unbox(params)
    port_cfg = tiny_test(pipe_size=2, pipe_interleave=2, num_microbatches=2)
    flat = params_to_jax(params_from_jax(tree, port_cfg), tiny_test())
    one = jgpt.tiny_test(dtype=jnp.float32, remat=False)
    loss_fn = jgpt.make_gpt_loss(one)
    batch = JTextBatch(tokens=jnp.asarray(b["tokens"]), targets=jnp.asarray(b["targets"]))
    g = jax.grad(lambda q: loss_fn(q, JGPTLM(one).apply, batch, jax.random.PRNGKey(0))[0])(
        jax.tree.map(jnp.asarray, flat))
    return tree, _unbox(g)


def _gen_prompt():
    rng = np.random.default_rng(5)
    prompt = rng.integers(1, 256, (4, 6)).astype(np.int32)
    mask = np.ones((4, 6), bool)
    mask[1, :2] = False
    mask[3, :4] = False
    return prompt, mask


def _packing_inputs():
    """``tests/test_pp.py:381``'s two 16-token documents per packed row, and
    ``:457``'s leakage batch (loss on segment 1, segment 0 perturbed)."""
    rng = np.random.default_rng(11)
    docs = rng.integers(0, 256, (8, 16))
    tgts = rng.integers(0, 256, (8, 16))
    ar = np.broadcast_to(np.arange(16), (4, 16))
    seg = np.concatenate([np.zeros((4, 16)), np.ones((4, 16))], 1).astype(np.int32)
    packed = dict(tokens=docs.reshape(4, 32), targets=tgts.reshape(4, 32),
                  loss_mask=np.ones((4, 32), np.float32), positions=np.concatenate([ar, ar], 1),
                  segment_ids=seg)
    unpacked = dict(tokens=docs, targets=tgts, loss_mask=np.ones((8, 16), np.float32),
                    positions=np.broadcast_to(np.arange(16), (8, 16)))
    toks = rng.integers(0, 256, (4, 32))
    leak = dict(tokens=toks, targets=rng.integers(0, 256, (4, 32)),
                loss_mask=(seg == 1).astype(np.float32), positions=np.concatenate([ar, ar], 1),
                segment_ids=seg)
    perturbed = toks.copy()
    perturbed[:, :16] = (perturbed[:, :16] + 7) % 256
    return packed, unpacked, leak, perturbed


def _make_inputs(outdir):
    rng = np.random.default_rng(0)
    params3d, example, _, _ = _jax_3d()
    g4params, gbatch, _, _ = _jax_gpipe()
    iparams, _ = _jax_interleaved()
    packed, unpacked, leak, perturbed = _packing_inputs()
    prompt, mask = _gen_prompt()
    inputs = {
        "pp_x": rng.standard_normal((8, 16)).astype(np.float32),
        "cls_inputs": rng.standard_normal((32, 16)).astype(np.float32),
        "cls_labels": rng.integers(0, 10, 32),
        "gen_prompt": prompt, "gen_mask": mask, "leak_perturbed": perturbed,
    }
    for prefix, tree in (("g4params", g4params), ("iparams", iparams), ("tparams", params3d),
                         ("gbatch", gbatch), ("dbatch", _batch(9, 24)), ("packed", packed),
                         ("unpacked", unpacked), ("leak", leak), ("example_3d", example)):
        inputs.update(flat_tree(prefix, tree))
    return inputs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_once("pp", tmp_path_factory, _make_inputs, num_ranks=NUM_RANKS)


def _leaves(out, prefix):
    return {k[len(prefix) + 1:]: v for k, v in out.items() if k.startswith(prefix + "/")}


def _own(out, prefix, want, **tol):
    """Each of this rank's leaves under ``prefix`` against ``want`` (the
    full weights' gradients by port name); returns how many it held."""
    got = _leaves(out, prefix)
    assert got
    for name, value in got.items():
        np.testing.assert_allclose(value, want[name], err_msg=f"{prefix}/{name}", **tol)
    return len(got)


def _full(tree, cfg):
    """A JAX tree (any layout) as full port weights by name, fp32."""
    return {k: v.numpy() for k, v in params_from_jax(tree, cfg, dtype=torch.float32).items()}


# -- tests/test_pp.py's generic pipeline (data=2 x pipe=4) -------------------


def _by_pipe(ranks, data=0):
    """The ranks of data coordinate ``data`` in pipe order."""
    found = {int(o["coords_p4"][0]): o for o in ranks if int(o["coords_p4"][1]) == data}
    return [found[p] for p in range(4)]


def test_pipeline_forward_equals_sequential(ranks):
    """The pipelined forward equals the four stage modules applied one after
    another (outputs broadcast over the pipe axis)."""
    x = np.random.default_rng(0).standard_normal((8, 16)).astype(np.float32)
    for d in (0, 1):
        ref = x[4 * d:4 * d + 4]
        for o in _by_pipe(ranks, d):
            h = torch.from_numpy(ref @ o["fwd_w"].T + o["fwd_b"])
            ref = ref + torch.nn.functional.silu(h).numpy()
        for o in _by_pipe(ranks, d):
            np.testing.assert_allclose(o["fwd_out"], ref, rtol=1e-4, atol=1e-5)
            assert bool(o["fwd_stage_tagged"])


def test_pipeline_stage_params_differ(ranks):
    stages = _by_pipe(ranks)
    for a in range(4):
        for b in range(a + 1, 4):
            assert not np.allclose(stages[a]["fwd_w"], stages[b]["fwd_w"]), (a, b)
    # data replicas of a stage hold the same weights
    for p, o in enumerate(_by_pipe(ranks, 1)):
        np.testing.assert_array_equal(o["fwd_w"], stages[p]["fwd_w"])


def test_pipeline_forwards_kwargs_to_stages(ranks):
    """``train=False`` reaches the stages: eval is deterministic under two
    dropout generators, training is not."""
    for o in ranks:
        assert bool(o["kwargs_eval_equal"]) and bool(o["kwargs_train_differs"])


def test_indivisible_microbatches_raise(ranks):
    for o in ranks:
        assert "not divisible by num_microbatches=3" in str(o["indivisible_error"])


def test_pp_replicated_params_stay_consistent(ranks):
    """The embedding and the head are replicated over pipe, one rank makes
    each one's gradient: the pipe sum keeps every rank bitwise equal."""
    for name in ("cls_embed_after5", "cls_head_after5"):
        for o in ranks[1:]:
            np.testing.assert_array_equal(o[name], ranks[0][name])


def test_pp_training_loss_decreases(ranks):
    for o in ranks:
        assert o["cls_losses"][-1] < o["cls_losses"][0]
        # the 32-sample global batch, counted on the last pipe rank only
        assert float(o["cls_count"]) == 32.0


# -- the tiny GPT: GPipe, FSDP x PP and 1F1B against JAX's GPipe -------------


@pytest.mark.parametrize("fsdp_on", [False, True])
@pytest.mark.parametrize("sched", ["gpipe", "1f1b"])
def test_gpipe_and_1f1b_grads_match_jax(ranks, sched, fsdp_on):
    """The synced gradients of the port's GPipe and 1F1B (with and without
    FSDP inside each stage) against JAX's GPipe on data=2 x pipe=4, leaf
    for leaf; the loss too.  Each rank checks the leaves it owns."""
    _, _, jgrads, jloss = _jax_gpipe()
    cfg = tiny_test(pipe_size=4)
    want = _full(jgrads, cfg)
    tag = f"{sched}{'_fsdp' if fsdp_on else ''}"
    seen = 0
    for o in ranks:
        seen += _own(o, f"g_{tag}", want, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(o[f"loss_{tag}"][0], jloss, rtol=1e-5)
        assert o[f"loss_{tag}"][1] == 8 * 32
    assert seen == NUM_RANKS * (len(want) - 5) // 4 + NUM_RANKS * 5


def test_gpipe_folds_stage_grads_into_fp32(ranks):
    """The reverse schedule moves each microbatch's stage gradients into
    the state's fp32 accumulators (``main_grad``) as it goes, so none is
    summed in the module's dtype."""
    for o in ranks:
        assert bool(o["folded_False"]) and bool(o["folded_True"])


def test_1f1b_matches_gpipe(ranks):
    """``tests/test_pp.py:528``: 1F1B's gradients equal GPipe's leaf for
    leaf (rtol 1e-5), without and with FSDP."""
    for o in ranks:
        for fsdp_tag in ("", "_fsdp"):
            gp, f1 = _leaves(o, f"g_gpipe{fsdp_tag}"), _leaves(o, f"g_1f1b{fsdp_tag}")
            assert gp.keys() == f1.keys()
            for name in gp:
                np.testing.assert_allclose(f1[name], gp[name], rtol=1e-5, atol=1e-6,
                                           err_msg=name)


def test_1f1b_deep_schedule_matches_gpipe(ranks):
    """``tests/test_pp.py:638``: pipe=4 with 12 microbatches, where the
    saved-input ring wraps.  Rank 0 re-embeds its tokens, so the longest
    lag on the ring is rank 1's 2n - 4 ticks: a planted ring of 2n - 4
    slots overwrites an input before its backward and is grossly wrong
    there."""
    for o in ranks:
        gp, f1 = _leaves(o, "deep_gpipe"), _leaves(o, "deep_1f1b")
        for name in gp:
            np.testing.assert_allclose(f1[name], gp[name], rtol=1e-5, atol=1e-6, err_msg=name)
    second = [o for o in ranks if int(o["coords_p4"][0]) == 1]
    for o in second:
        gp, bad = _leaves(o, "deep_gpipe"), _leaves(o, "deep_1f1b_small_ring")
        worst = max(np.abs(bad[n] - gp[n]).max() / (np.abs(gp[n]).max() + 1e-12)
                    for n in gp if n.startswith("blocks."))
        assert worst > 0.1, worst


def test_p2p_launches_per_step(ranks):
    """Bubbles send nothing: under GPipe with m microbatches over n stages
    a rank sends m activations forward (not the last) and m gradients
    back (not the first), and receives as many; 1F1B the same."""
    for o in ranks:
        r = int(o["coords_p4"][0])
        want = 4 * (r < 3) + 4 * (r > 0)
        for tag in ("gpipe", "1f1b", "gpipe_fsdp", "1f1b_fsdp"):
            assert o[f"p2p_{tag}"].tolist() == [want, want], tag


def test_interleaved_pipeline_matches_sequential(ranks):
    """``tests/test_pp.py:243``: the circular schedule (pipe=2, 2 virtual
    stages) from JAX's interleaved init: rank r's chunk j is global chunk
    2j + r; its forward equals one process's on the same weights, and its
    synced gradients equal the one-stage twin's (JAX) leaf for leaf."""
    tree, jgrads = _jax_interleaved()
    cfg = tiny_test(pipe_size=2, pipe_interleave=2)
    want = {k: v.numpy() for k, v in params_from_jax(jgrads, tiny_test(),
                                                     dtype=torch.float32).items()}
    for o in ranks:
        r = int(o["coords_p2d4"][0])
        assert o["inter_layer_ids"].tolist() == stage_layers(cfg, r) == [r, r + 2]
        if "inter_fwd_err" in o:
            assert float(o["inter_fwd_err"]) < 1e-5
        _own(o, "g_inter", want, rtol=2e-4, atol=1e-6)


# -- packed sequences under PP -----------------------------------------------


@pytest.mark.parametrize("interleave", [1, 2])
def test_pp_packed_loss_equals_unpacked(ranks, interleave):
    for o in ranks:
        packed, unpacked = o[f"packed_{interleave}"]
        assert abs(packed - unpacked) < 2e-4, (packed, unpacked)


def test_pp_packed_leakage_blocked(ranks):
    for o in ranks:
        base, pert = o["leak"]
        assert abs(base - pert) < 1e-6, (base, pert)


# -- the gradient scale under TP x PP ----------------------------------------


def test_tp_pp_synced_grads_match_dense(ranks):
    """On data=2 x model=2 x pipe=2 the synced gradients (the
    model-split ones assembled over the model axis) equal one process's
    dense gradients on the same weights and the global batch; a planted
    missing division by the model axis and a planted extra one each put
    the model-split leaves off by 2x."""
    dense = _leaves(ranks[0], "scale_dense")
    split = ("attn.qkv", "attn.out.weight", "mlp.up", "mlp.down.weight", "lm_head")
    for o in ranks:
        _own(o, "scale_good", dense, rtol=1e-4, atol=1e-6)
        for fault in ("no_div", "extra_div"):
            got = _leaves(o, f"scale_{fault}")
            bad = [n for n in got if any(s in n for s in split)]
            assert bad
            for name in bad:
                assert not np.allclose(got[name], dense[name], rtol=1e-4, atol=1e-6), name
            for name in set(got) - set(bad):
                np.testing.assert_allclose(got[name], dense[name], rtol=1e-4, atol=1e-6)


# -- decoding over a pipe mesh -----------------------------------------------


def test_generate_sharded_pp_matches_jax(ranks):
    """``tests/test_generate.py:453``: greedy ``generate_sharded`` over
    data=2 x model=2 x pipe=2 on JAX's init (ragged prompts) gives JAX's
    tokens exactly, on every rank."""
    want = _jax_3d()[3]
    for o in ranks:
        np.testing.assert_array_equal(o["gen_greedy"], want)


def test_pp_full_forward_logits_have_full_vocab_on_every_rank(ranks):
    """Under TP x PP (data=2 x model=2 x pipe=2) the full forward gives
    logits of the whole vocabulary on every rank, as JAX does: the last
    rank's gathered column lm_head, zeros of the same shape elsewhere."""
    want = (*_gen_prompt()[0].shape, tiny_test().vocab_size)
    for o in ranks:
        assert tuple(o["full_logits_shape"]) == want, o["full_logits_shape"]


def test_generate_sharded_sampled_same_on_every_rank(ranks):
    for o in ranks[1:]:
        np.testing.assert_array_equal(o["gen_sampled"], ranks[0]["gen_sampled"])


def test_pp_decode_prefill_logits_match_train_forward(ranks):
    """``tests/test_generate.py:515``: a decode-mode prefill through the
    4-stage ring gives the training forward's logits (each stage's cache
    holds only its own layers)."""
    last = [o for o in ranks if bool(o["prefill_last_stage"])]
    assert len(last) == 2
    for o in last:
        assert float(o["prefill_err"]) < 1e-5
    for o in ranks:
        assert int(o["prefill_cache_layers"]) == 1


# -- the Trainer over DP x TP x PP -------------------------------------------


def test_trainer_tiny_3d_matches_jax(ranks):
    """``tests/test_train_lib.py::test_trainer_tiny_3d``: the mesh dictates
    ``pipe_size``; 4 steps from JAX's init on JAX's example batch give
    JAX's losses (rtol 1e-5), the same on every rank."""
    want = _jax_3d()[2]
    for o in ranks:
        assert int(o["trainer_pipe_size"]) == 2
        np.testing.assert_allclose(o["trainer_losses"], want, rtol=1e-5)
        assert int(o["trainer_num_params"]) == sum(
            p.numel() for p in GPTLM(tiny_test(), device="cpu").parameters())
        # GPipe over 2 stages and 2 microbatches: 2 sends and 2 receives a step
        assert o["trainer_p2p_per_step"].tolist() == [2.0, 2.0]


def test_pp_checkpoint_round_trip(ranks):
    """Every rank writes its own stage's keys; a fresh Trainer restores them
    bitwise, and both take the same 2 more steps."""
    for o in ranks:
        assert int(o["ckpt_step"]) == 2 and bool(o["ckpt_bitwise"])
        a, b = o["ckpt_more_losses"]
        assert a == b
        p = int(o["coords_222"][0])
        layers = {k.split(".")[1] for k in o["ckpt_keys"] if k.startswith("blocks.")}
        assert layers == {f"layer_{i}" for i in (2 * p, 2 * p + 1)}


def test_1f1b_bf16_trains(ranks):
    """``tests/test_pp.py:716``: 1F1B in bf16 runs a Trainer step."""
    for o in ranks:
        assert np.isfinite(o["bf16_1f1b_loss"]) and o["bf16_1f1b_loss"] > 0


def test_export_refuses_pipe(ranks):
    for o in ranks:
        assert "split over mesh axis 'pipe' (size 4)" in str(o["export_error"])
        assert "export requires tp/pipe degree 1" in str(o["export_error"])


# -- the bridge ---------------------------------------------------------------


def _rank_dicts(tree, cfg, tp):
    """Every rank's state dict from a JAX pipe tree, (pipe, model) order."""
    return [params_from_jax(tree, cfg, model_rank=m if tp > 1 else None, pipe_rank=p)
            for p in range(cfg.pipe_size) for m in range(tp)]


def _assert_tree_equal(got, want):
    got_flat = dict(flat_tree("t", got))
    want_flat = dict(flat_tree("t", want))
    assert got_flat.keys() == want_flat.keys()
    for k in want_flat:
        np.testing.assert_array_equal(np.asarray(got_flat[k], np.float32), want_flat[k],
                                      err_msg=k)


def test_bridge_round_trips_pipe_trees(ranks):
    """``params_from_jax`` / ``params_to_jax`` round-trip JAX's pipe tree
    under TP (2x2x2) and its interleaved tree, and the port ranks' own
    state dicts give JAX's interleaved tree back."""
    params3d = _jax_3d()[0]
    cfg = tiny_test(pipe_size=2, num_microbatches=2)
    _assert_tree_equal(params_to_jax(_rank_dicts(params3d, cfg, 2), cfg), params3d)
    tree, _ = _jax_interleaved()
    cfg_i = tiny_test(pipe_size=2, pipe_interleave=2, num_microbatches=2)
    _assert_tree_equal(params_to_jax(_rank_dicts(tree, cfg_i, 1), cfg_i), tree)
    by_pipe = {int(o["coords_p2d4"][0]): o for o in ranks if int(o["coords_p2d4"][1]) == 0}
    sds = [{k: torch.from_numpy(v) for k, v in _leaves(by_pipe[p], "inter_sd").items()}
           for p in range(2)]
    _assert_tree_equal(params_to_jax(sds, cfg_i), tree)
    with pytest.raises(KeyError):
        params_from_jax({"pipeline": tree["pipeline"]}, cfg_i)
    with pytest.raises(ValueError, match="pipe_rank=2 of 2"):
        params_from_jax(tree, cfg_i, pipe_rank=2)


# -- refusals, in JAX's words -------------------------------------------------


def _jax_error(fn):
    with pytest.raises(Exception) as exc:
        fn()
    return exc.value


@pytest.mark.parametrize("case", ["engine", "export_single", "1f1b_interleave",
                                  "grad_fn_minibatches", "unknown_schedule",
                                  "interleave_without_pipe", "indivisible_layers"])
def test_pipeline_refusals(case):
    from tpu_parallel_torch.parallel.spmd import build_train_functions
    from tpu_parallel_torch.serving import ServingEngine
    from tpu_parallel_torch.train_lib import Trainer, TrainerConfig

    if case == "engine":
        model = GPTLM(tiny_test(pipe_size=2), device="cpu")
        with pytest.raises(NotImplementedError, match="serve pipe meshes through "
                           "generate_sharded, not the serving engine"):
            ServingEngine(model, n_slots=2)
    elif case == "export_single":
        # no pipe axis bound: a pipe config decodes nowhere (JAX's words)
        model = GPTLM(tiny_test(pipe_size=2), device="cpu")
        with pytest.raises(ValueError, match="mesh axis bound: serve through "
                           "generate_sharded") as got:
            model(torch.zeros(1, 3, dtype=torch.long), decode=True, cache=model.init_cache(1))
        jm = JGPTLM(jgpt.tiny_test(pipe_size=2))
        want = _jax_error(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 3), jnp.int32),
                                          decode=True, train=False))
        assert str(got.value) == str(want)
    elif case == "1f1b_interleave":
        with pytest.raises(NotImplementedError) as got:
            make_gpt_1f1b_grad_fn(tiny_test(pipe_size=2, pipe_interleave=2))
        want = _jax_error(lambda: jgpt.make_gpt_1f1b_grad_fn(
            jgpt.tiny_test(pipe_size=2, pipe_interleave=2)))
        assert str(got.value) == str(want)
    elif case == "grad_fn_minibatches":
        from tpu_parallel_torch.core.optim import AdamW
        from tpu_parallel_torch.parallel.spmd import make_model_init

        init = make_model_init(GPTLM(tiny_test(), device="cpu"), AdamW(lambda c: 1e-3))
        with pytest.raises(ValueError, match="num_minibatches > 1 does not compose with a "
                           "schedule-owned grad_fn"):
            build_train_functions(init, None, None, grad_fn=lambda *a: None, num_minibatches=2)
    elif case == "unknown_schedule":
        with pytest.raises(ValueError, match=r"pipe_schedule='zb' \(gpipe \| 1f1b\)"):
            Trainer(TrainerConfig(model="tiny", model_overrides=dict(pipe_schedule="zb")),
                    device="cpu")
    elif case == "interleave_without_pipe":
        with pytest.raises(ValueError, match="pipe_interleave > 1 requires pipe_size > 1"):
            GPTLM(tiny_test(pipe_interleave=2), device="cpu")
    elif case == "indivisible_layers":
        with pytest.raises(ValueError, match=r"n_layers=4 not divisible by "
                           r"pipe_size\*pipe_interleave=3"):
            GPTLM(tiny_test(pipe_size=3), device="cpu")


# -- configs and the CLI ------------------------------------------------------


def test_pipeline_configs_load():
    """``gpt2_350m_pp`` and ``tiny_3d_cpu`` are the JAX configs' values (the
    field-for-field check is ``tests/test_torch_fit.py``'s); GPT-2 350M has
    JAX's widths."""
    assert get_config("gpt2_350m_pp")["mesh"] == dict(data=-1, model=1, pipe=4, seq=1)
    assert get_config("tiny_3d_cpu")["mesh"] == dict(data=2, model=2, pipe=2, seq=1)
    port, ref = gpt2_350m(), jgpt.gpt2_350m()
    for name in ("vocab_size", "d_model", "n_layers", "n_heads", "seq_len", "head_dim"):
        assert getattr(port, name) == getattr(ref, name)
    cfg = gpt2_350m(pipe_size=4, pipe_interleave=2)
    assert [stage_layers(cfg, r) for r in (0, 3)] == [[0, 1, 2, 12, 13, 14],
                                                      [9, 10, 11, 21, 22, 23]]


def test_tiny_3d_cli_trains_on_eight_ranks():
    """``python -m tpu_parallel_torch.train --config tiny_3d_cpu`` starts 8
    gloo CPU processes over data=2 x model=2 x pipe=2 and the loss falls."""
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_parallel_torch.train", "--config=tiny_3d_cpu",
         "--config.steps=10"], cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    losses = [float(line.split("loss=")[1].split()[0]) for line in proc.stdout.splitlines()
              if line.startswith("step ")]
    assert len(losses) == 2 and losses[1] < losses[0], proc.stdout
    assert '"process_count": 8' in proc.stdout


def test_pp_schedule_tables():
    """The host tables: GPipe is the interleave-1 case (m + n - 1 ticks,
    rank r on microbatch t - r); the interleaved schedule visits each
    (microbatch, chunk) once per rank in JAX's inject order."""
    assert pp.schedule_steps(4, 1, 8, 2) == [(t, 0, t - 2) for t in range(2, 10)]
    steps = pp.schedule_steps(4, 2, 8, 0)
    assert sorted((i, j) for _, j, i in steps) == [(i, j) for i in range(8) for j in range(2)]
    assert [pp.inject_tick(i, 4, 2) for i in range(8)] == [0, 1, 2, 3, 8, 9, 10, 11]
    assert max(t for t, _, _ in pp.schedule_steps(4, 2, 8, 3)) == pp.inject_tick(7, 4, 2) + 7
