"""Worker ranks for the port's multi-rank tests: the counterpart of
``tests/multihost_worker.py``.

    python tests/torch_dp_worker.py <suite> <outdir> <num_ranks>

Starts ``num_ranks`` gloo CPU processes through
``tpu_parallel_torch.runtime.spawn_cpu_ranks`` and runs every case of
``suite`` (``runtime``, ``dp``, ``fsdp``, ``tp``, ``pp``, ``sp``, ``moe``,
``llama``, ``encoder`` or ``seq2seq``) in that one group.  Each rank reads the
inputs the test wrote to ``<outdir>/inputs.npz`` and writes its results to
``<outdir>/<suite>_rank<r>.npz``; the test compares them with the JAX
package in its own process.  Imports torch, numpy and the port only.

:func:`run_once` is the tests' side: it writes the inputs and runs the
group once per pytest run, even when pytest-xdist spreads a module's
tests over several workers.
"""

from __future__ import annotations

import fcntl
import functools
import json
import math
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM_RANKS = 4


def flat_tree(prefix, tree):
    """``{prefix/path: array}`` of a nested dict of arrays."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_tree(f"{prefix}/{k}", v))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


def nested_tree(prefix, flat):
    """The inverse of :func:`flat_tree` for the keys under ``prefix/``."""
    tree = {}
    for key, value in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        node = tree
        *parents, leaf = key[len(prefix) + 1:].split("/")
        for name in parents:
            node = node.setdefault(name, {})
        node[leaf] = value
    return tree


def run_once(suite, tmp_path_factory, make_inputs, num_ranks=NUM_RANKS):
    """Run ``suite`` once per pytest run in ``num_ranks`` ranks and return
    their outputs (a list of dicts, one per rank).  ``make_inputs(outdir)`` returns the
    arrays of ``inputs.npz`` (it may write other files into ``outdir``).
    Under pytest-xdist the workers share one directory and a file lock, so
    the first worker runs the group and the others read its files."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent  # the run's directory, shared by its workers
    outdir = base / f"torch_ranks_{suite}"
    outdir.mkdir(exist_ok=True)
    with open(outdir / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            done = outdir / "done.json"
            if not done.exists():
                np.savez(outdir / "inputs.npz", **make_inputs(outdir))
                env = dict(os.environ, PYTHONPATH=REPO)
                proc = subprocess.run(
                    [sys.executable, os.path.abspath(__file__), suite, str(outdir),
                     str(num_ranks)], cwd=REPO, env=env, capture_output=True, text=True,
                    timeout=600)
                done.write_text(json.dumps(dict(returncode=proc.returncode,
                                                log=(proc.stdout + proc.stderr)[-20000:])))
            status = json.loads(done.read_text())
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    assert status["returncode"] == 0, status["log"]
    return [dict(np.load(outdir / f"{suite}_rank{r}.npz")) for r in range(num_ranks)]


# -- the ranks' side ----------------------------------------------------------


def _runtime_cases(inputs, outdir, out):
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from tpu_parallel_torch.core.metrics import compute, metric, sync_metrics
    from tpu_parallel_torch.core.optim import ClipByGlobalNormSharded, global_norm_sharded
    from tpu_parallel_torch.core.rng import fold_rng_over_axis
    from tpu_parallel_torch.runtime import (MeshConfig, initialize, is_simulated, make_mesh,
                                            mesh_from_sizes, process_info)

    rank = dist.get_rank()
    # (1) meshes
    mesh = make_mesh(MeshConfig(data=4))
    out["mesh_shape"] = np.array(mesh.shape)
    out["mesh_names"] = np.array(mesh.mesh_dim_names)
    out["mesh_data_ranks"] = np.array(dist.get_process_group_ranks(mesh.get_group("data")))
    out["mesh_data_coord"] = np.array(mesh.get_local_rank("data"))
    out["mesh_wild_shape"] = np.array(mesh_from_sizes(data=-1).shape)
    mesh22 = make_mesh(MeshConfig(data=2, model=2))
    out["mesh22_shape"] = np.array(mesh22.shape)
    for axis in ("data", "model"):
        out[f"mesh22_{axis}_ranks"] = np.array(
            dist.get_process_group_ranks(mesh22.get_group(axis)))
    for name, cfg in (("cover", MeshConfig(data=3)), ("wild", MeshConfig(data=-1, model=3)),
                      ("two_wild", MeshConfig(data=-1, model=-1))):
        try:
            make_mesh(cfg)
            out[f"mesh_error_{name}"] = np.array("")
        except ValueError as exc:
            out[f"mesh_error_{name}"] = np.array(str(exc))
    # (2) initialize() without torchrun's environment is a no-op in a group
    initialize()
    out["info"] = np.array(json.dumps(process_info()))
    out["simulated"] = np.array(is_simulated())
    # (3) per-rank generators
    gen = torch.Generator().manual_seed(0)
    out["fold_draw"] = torch.randn(4, generator=fold_rng_over_axis(gen, "data", mesh)).numpy()
    again = fold_rng_over_axis(torch.Generator().manual_seed(0), "data", mesh)
    out["fold_draw_again"] = torch.randn(4, generator=again).numpy()
    out["fold_replicated_next"] = torch.randn(2, generator=gen).numpy()
    out["fold_unbound_is_identity"] = np.array(
        fold_rng_over_axis(gen, "nope", mesh) is gen and fold_rng_over_axis(gen, "data") is gen)
    both = fold_rng_over_axis(torch.Generator().manual_seed(0), ("data", "model"), mesh22)
    out["fold_draw_22"] = torch.randn(4, generator=both).numpy()
    # (4) metrics: arange(16) over 4 ranks; a mean axis; a replicated metric
    x = torch.arange(16.0)[4 * rank:4 * rank + 4]
    synced = sync_metrics({"loss": metric(x.sum(), 4), "rep": metric(2.0, 1)}, "data",
                          mesh=mesh)
    out["sync_loss"] = np.array(compute(synced)["loss"])
    out["sync_rep"] = np.array([float(t) for t in synced["rep"]])
    meaned = sync_metrics({"acc": metric(float(rank), 1)}, (), mean_axes="data", mesh=mesh)
    out["sync_mean"] = np.array([float(t) for t in meaned["acc"]])
    out["sync_unbound_is_identity"] = np.array(
        sync_metrics(synced, "data") is synced and sync_metrics(synced, "nope", mesh=mesh)
        is synced)
    # (4b) gradient sync: separate tensors (through a flattened copy) and
    # views of one flat buffer (in place), one all-reduce each
    from tpu_parallel_torch.parallel import dp

    before = dp.dp_allreduce_launches
    grads = {"a": torch.full((3,), float(rank)), "b": torch.full((2, 2), 2.0 * rank)}
    dp.sync_gradients_dp(grads, "data", mesh)
    flat = torch.full((7,), float(rank))
    views = {"a": flat[:3], "b": flat[3:].view(2, 2)}
    dp.sync_gradients_dp(views, "data", mesh)
    out["sync_grads_separate"] = torch.cat([grads["a"], grads["b"].reshape(-1)]).numpy()
    out["sync_grads_flat"] = flat.numpy()
    out["sync_grads_launches"] = np.array(dp.dp_allreduce_launches - before)
    # (5) the sharded norm and clip (tests/test_optim.py:13-58 on a data=4 mesh)
    placements = [Shard(0) if n == "data" else Replicate() for n in mesh.mesh_dim_names]
    grads = {"sharded": DTensor.from_local(torch.full((2,), float(rank)), mesh, placements),
             "replicated": torch.ones(3)}
    out["norm"] = global_norm_sharded(grads).numpy()
    grads = {"sharded": DTensor.from_local(torch.full((4,), rank + 1.0), mesh, placements),
             "replicated": torch.full((4,), 2.0)}
    clipped, _ = ClipByGlobalNormSharded(1.0).update(grads, None)
    out["clip_replicated"] = clipped["replicated"].numpy()
    out["clip_sharded_full"] = clipped["sharded"].full_tensor().numpy()


def _text_batch(inputs, prefix):
    import torch

    from tpu_parallel_torch.core.state import TextBatch

    fields = {}
    for name in ("tokens", "targets", "loss_mask", "segment_ids", "positions"):
        key = f"{prefix}/{name}"
        if key in inputs:
            value = torch.from_numpy(inputs[key].copy())
            fields[name] = value.int() if name == "segment_ids" else (
                value if name == "loss_mask" else value.long())
    return TextBatch(**fields)


def _masters(out, prefix, state):
    for name, value in state.params.items():
        out[f"{prefix}/{name}"] = value.detach().numpy().copy()


def _dp_cases(inputs, outdir, out):
    import torch
    import torch.distributed as dist

    from tpu_parallel_torch.checkpoint import Checkpointer, params_fingerprint
    from tpu_parallel_torch.core.losses import make_classification_loss
    from tpu_parallel_torch.core.metrics import accumulate_metrics, compute
    from tpu_parallel_torch.core.optim import AdamW
    from tpu_parallel_torch.core.state import Batch, TrainState
    from tpu_parallel_torch.data import DataLoader, TokenDataset, make_global_batch
    from tpu_parallel_torch.models.convert import params_from_jax, params_to_jax
    from tpu_parallel_torch.models.mlp import MLPClassifier, MLPConfig
    from tpu_parallel_torch.parallel import dp
    from tpu_parallel_torch.runtime import MeshConfig, make_mesh
    from tpu_parallel_torch.train_lib import Trainer, TrainerConfig

    rank = dist.get_rank()
    mesh = make_mesh(MeshConfig(data=4))

    # (6) the MLP DP step: 3 steps of AdamW(1e-3), 2 minibatches, from the
    # bridged JAX init, on this rank's block of the global batch
    cfg = MLPConfig(hidden_size=64, num_classes=10, dropout_rate=0.0, dtype=torch.float32)
    tree = nested_tree("mlp", inputs)
    inputs_all = torch.from_numpy(inputs["mlp_inputs"].copy())
    labels_all = torch.from_numpy(inputs["mlp_labels"].copy()).long()
    local = inputs_all.shape[0] // 4

    def mlp_init():
        model = MLPClassifier(cfg, inputs_all.shape[1], device="cpu", seed=rank)
        return TrainState.create(model, AdamW(lambda count: 1e-3), torch.Generator().manual_seed(0),
                                 params_from_jax(tree, cfg, dtype=torch.float32))

    state = dp.make_init(mlp_init, mesh=mesh)()
    step = dp.make_train_step(make_classification_loss("data", mesh), num_minibatches=2,
                              mesh=mesh)
    batch = Batch(inputs=inputs_all[rank * local:(rank + 1) * local],
                  labels=labels_all[rank * local:(rank + 1) * local])
    losses, launches = [], dp.dp_allreduce_launches
    for _ in range(3):
        state, metrics = step(state, None, batch)
        losses.append(compute(metrics)["loss"])
    out["mlp_losses"] = np.array(losses)
    out["mlp_count"] = np.array(float(metrics["loss"][1]))
    out["mlp_allreduces"] = np.array(dp.dp_allreduce_launches - launches)
    _masters(out, "mlp_params", state)
    for name, value in state.opt_state["mu"].items():
        out[f"mlp_mu/{name}"] = value.numpy().copy()

    # (7) the loader: rows p::P of each global batch, and the stitched view
    ds = TokenDataset(os.path.join(outdir, "corpus.bin"), seq_len=16)
    loader = DataLoader(ds, 8, seed=7, device="cpu")
    out["loader_local"] = np.stack([loader.batch_at(s).tokens.numpy() for s in range(3)])
    out["loader_global"] = np.stack([
        make_global_batch(loader.batch_at(s), mesh).tokens.full_tensor().numpy()
        for s in range(3)])
    out["loader_local_batch_size"] = np.array(loader.local_batch_size)

    # (8) the Trainer on tiny_test against JAX's on data=4: xla and flash,
    # and one step on a packed batch whose ranks count different tokens
    params0 = nested_tree("tparams", inputs)
    example = _text_batch(inputs, "example")
    packed = _text_batch(inputs, "packed")
    for impl in ("xla", "flash"):
        trainer = Trainer(TrainerConfig(model="tiny", global_batch_size=8, num_minibatches=2,
                                        steps=3, warmup_steps=2,
                                        model_overrides=dict(attn_impl=impl)),
                          mesh=mesh, device="cpu")
        tstate = trainer.init(params_from_jax(params0, trainer.model_config,
                                              dtype=torch.float32))
        local_batch = trainer.local_rows(example)
        losses = []
        for _ in range(3):
            tstate, metrics = trainer.step_fn(tstate, None, local_batch)
            losses.append(compute(metrics)["loss"])
        out[f"trainer_{impl}_losses"] = np.array(losses)
        _masters(out, f"trainer_{impl}", tstate)
        if impl == "xla":
            trainer.init(params_from_jax(params0, trainer.model_config, dtype=torch.float32))
            local_packed = trainer.local_rows(packed)
            out["packed_local_tokens"] = np.array(float(local_packed.loss_mask.sum()))
            tstate, losses = trainer.state, []
            for _ in range(2):
                tstate, metrics = trainer.step_fn(tstate, None, local_packed)
                losses.append(compute(metrics)["loss"])
            out["packed_losses"] = np.array(losses)
            _masters(out, "packed", tstate)

    # (9) dropout 0.1: per-rank masks that repeat, a replicated generator
    trainer = Trainer(TrainerConfig(model="tiny", global_batch_size=8, num_minibatches=2,
                                    steps=2, warmup_steps=1,
                                    model_overrides=dict(dropout_rate=0.1)),
                      mesh=mesh, device="cpu")
    trainer.init(params_from_jax(params0, trainer.model_config, dtype=torch.float32))
    same_rows = example.rows(0, 2)
    with torch.no_grad():
        out["dropout_loss"] = np.array([
            trainer.loss_fn(trainer.model, same_rows, torch.Generator().manual_seed(3))[0].item()
            for _ in range(2)])
    tstate = trainer.state
    for _ in range(2):
        tstate, _ = trainer.step_fn(tstate, None, trainer.local_rows(example))
    out["dropout_rng_state"] = tstate.rng.get_state().numpy().copy()
    _masters(out, "dropout", tstate)

    # (10) fit with checkpoints and keep-best: one writer, every rank
    # resumes, and a loss made non-finite on rank 1 alone rolls back every
    # rank
    writes = []
    write = Checkpointer._write

    def counting_write(self, step, snapshot, event):
        writes.append(f"{os.path.basename(self.directory)}:{step}")
        return write(self, step, snapshot, event)

    Checkpointer._write = counting_write
    ckpt_dir = os.path.join(outdir, "ckpt")
    corpus = TokenDataset(os.path.join(outdir, "corpus.bin"), seq_len=32)
    fit_config = dict(model="tiny", global_batch_size=8, num_minibatches=1, warmup_steps=1,
                      steps=4)

    def fit_trainer(steps):
        t = Trainer(TrainerConfig(**{**fit_config, "steps": steps}), mesh=mesh, device="cpu")
        seen = []
        real = t.step_fn

        def step_fn(state, metrics, batch):
            seen.append(state.step)
            return real(state, metrics, batch)

        t.step_fn = step_fn
        return t, seen

    def fingerprint(t):
        return params_fingerprint(params_to_jax(t.state.params, t.model_config))

    def loader():
        return DataLoader(corpus, 8, seed=1, holdout_fraction=0.2, device="cpu")

    evals = []
    t1, seen1 = fit_trainer(4)
    t1.fit(ckpt_dir, data_loader=loader(), checkpoint_every=2, eval_every=2, eval_steps=2,
           keep_best=True, log_fn=lambda step, m: evals.append(m.get("eval_loss", np.nan)))
    out["fit_writes"] = np.array(writes)
    out["fit_eval_losses"] = np.array([x for x in evals if not np.isnan(x)])
    best = os.path.join(ckpt_dir, "best", "best_loss.json")
    out["fit_best"] = np.array(open(best).read() if os.path.exists(best) else "")
    out["fit_fingerprint"] = np.array(fingerprint(t1))
    t2, seen2 = fit_trainer(6)
    t2.fit(ckpt_dir, data_loader=loader(), checkpoint_every=2)
    out["resume_steps_seen"] = np.array(seen2)
    out["resume_fingerprint"] = np.array(fingerprint(t2))
    t3, seen3 = fit_trainer(8)
    real_loss, planted, raised = t3.loss_fn, [rank == 1], []

    def poisoned_loss(model, batch, rng):
        loss, metrics = real_loss(model, batch, rng)
        if planted[0] and t3.state.step == 6:
            planted[0] = False
            nan = float("nan")
            return loss * nan, {k: (s * nan, c) for k, (s, c) in metrics.items()}
        return loss, metrics

    t3.loss_fn = poisoned_loss
    counted = t3.step_fn

    def guarded_step(state, metrics, batch):
        # the fit's seam: decide on the synced loss, the same on every rank
        state, step_metrics = counted(state, None, batch)
        if not math.isfinite(compute(step_metrics)["loss"]):
            raised.append(state.step)
            raise FloatingPointError(f"non-finite loss after step {state.step}")
        return state, accumulate_metrics(metrics, step_metrics)

    t3.step_fn = guarded_step
    t3.fit(ckpt_dir, data_loader=loader(), checkpoint_every=2)
    Checkpointer._write = write
    out["rollback_raised"] = np.array(raised)
    out["rollback_steps_seen"] = np.array(seen3)
    out["rollback_final_step"] = np.array(t3.state.step)
    out["rollback_finite"] = np.array(all(bool(torch.isfinite(p).all())
                                          for p in t3.state.params.values()))
    out["rollback_fingerprint"] = np.array(fingerprint(t3))
    out["fit_writes_all"] = np.array(writes)


def _locals(out, prefix, tree):
    """This rank's tensors of ``tree`` (a dict by parameter name)."""
    for name, value in tree.items():
        value = value.to_local() if hasattr(value, "to_local") else value
        out[f"{prefix}/{name}"] = value.detach().numpy().copy()


def _fsdp_cases(inputs, outdir, out):
    import warnings

    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from tpu_parallel_torch.checkpoint import params_fingerprint
    from tpu_parallel_torch.core.accumulate import accumulate_gradients
    from tpu_parallel_torch.core.losses import make_classification_loss
    from tpu_parallel_torch.core.metrics import compute
    from tpu_parallel_torch.core.optim import AdamW
    from tpu_parallel_torch.core.state import Batch
    from tpu_parallel_torch.models import GPTLM, tiny_test
    from tpu_parallel_torch.models.convert import params_from_jax, params_to_jax
    from tpu_parallel_torch.models.generate import export_single_device_params, generate
    from tpu_parallel_torch.models.gpt import make_gpt_loss
    from tpu_parallel_torch.models.mlp import MLPClassifier, MLPConfig
    from tpu_parallel_torch.parallel import dp, fsdp
    from tpu_parallel_torch.parallel.spmd import build_train_functions, make_model_init
    from tpu_parallel_torch.runtime import MeshConfig, make_mesh
    from tpu_parallel_torch.train_lib import Trainer, TrainerConfig

    rank = dist.get_rank()
    mesh = make_mesh(MeshConfig(data=4))

    # (1) the MLP of tests/test_fsdp.py: every Dense FSDP-wrapped
    cfg = MLPConfig(hidden_size=64, num_classes=10, dropout_rate=0.0, dtype=torch.float32)
    tree = nested_tree("mlp", inputs)
    x_all = torch.from_numpy(inputs["mlp_inputs"].copy())
    y_all = torch.from_numpy(inputs["mlp_labels"].copy()).long()

    def mlp_funcs(min_size=0, sharded=True, minibatches=1):
        wrapper = (lambda cls: fsdp.shard_module_params(cls, "data", min_size, mesh=mesh)) \
            if sharded else None
        model = MLPClassifier(cfg, x_all.shape[1], dense_wrapper=wrapper, device="cpu")
        return build_train_functions(make_model_init(model, AdamW(lambda count: 1e-3)),
                                     make_classification_loss("data", mesh), mesh,
                                     num_minibatches=minibatches)

    def rows(n):
        local = n // 4
        return Batch(inputs=x_all[:n][rank * local:(rank + 1) * local],
                     labels=y_all[:n][rank * local:(rank + 1) * local])

    params0 = params_from_jax(tree, cfg, dtype=torch.float32)
    funcs = mlp_funcs()
    state = funcs.init_fn(torch.Generator().manual_seed(0), params0)
    for name, p in state.model.named_parameters():
        out[f"mlp_shape/{name}"] = np.array(p.shape)
        out[f"mlp_mu_shape/{name}"] = np.array(state.opt_state["mu"][name].shape)
        out[f"mlp_spec/{name}"] = np.array(json.dumps(funcs.state_specs[name]))
    _locals(out, "mlp_init", state.params)
    losses = []
    for _ in range(3):
        state, metrics = funcs.step_fn(state, None, rows(64))
        losses.append(compute(metrics)["loss"])
    out["mlp_fsdp_losses"] = np.array(losses)
    for name, value in export_single_device_params(state.partitioned(state.params)).items():
        out[f"mlp_fsdp/{name}"] = value.numpy().copy()
    dstate = dp.make_init(lambda: mlp_funcs(sharded=False).init_fn(
        torch.Generator().manual_seed(0), params0), mesh=mesh)()
    step = dp.make_train_step(make_classification_loss("data", mesh), mesh=mesh)
    losses = []
    for _ in range(3):
        dstate, metrics = step(dstate, None, rows(64))
        losses.append(compute(metrics)["loss"])
    out["mlp_dp_losses"] = np.array(losses)
    _masters(out, "mlp_dp", dstate)
    funcs = mlp_funcs(minibatches=4)
    state = funcs.init_fn(torch.Generator().manual_seed(0), params0)
    losses = []
    for _ in range(16):
        state, metrics = funcs.step_fn(state, None, rows(128))
        losses.append(compute(metrics)["loss"])
    out["mlp_decrease_losses"] = np.array(losses)
    out["mlp_min_size_shards"] = np.array(len(
        mlp_funcs(min_size=2**18).init_fn(torch.Generator(), params0).shards))

    # (2) sync_gradients: a sharded leaf keeps its value, a replicated one
    # takes the mean over the data axis
    placements = [Shard(0) if n == "data" else Replicate() for n in mesh.mesh_dim_names]
    grads = {"sharded": DTensor.from_local(torch.ones(1) * rank, mesh, placements),
             "replicated": torch.ones(1) * rank}
    synced = fsdp.sync_gradients(grads, ("data",), mesh=mesh)
    out["sync_sharded"] = synced["sharded"].full_tensor().numpy()
    out["sync_replicated"] = synced["replicated"].numpy()
    mesh22 = make_mesh(MeshConfig(data=2, model=2))
    data, model = mesh22.get_local_rank("data"), mesh22.get_local_rank("model")
    on_model = [Shard(0) if n == "model" else Replicate() for n in mesh22.mesh_dim_names]
    grads = {"replicated": torch.ones(1) * (1.0 + data + model),
             "model_sharded": DTensor.from_local(torch.ones(1) * (1.0 + model), mesh22,
                                                 on_model)}
    fsdp.sync_gradients(grads, ("data", "model"), psum_axes=("model",), mesh=mesh22)
    out["sync22_replicated"] = grads["replicated"].numpy()
    out["sync22_model_sharded"] = grads["model_sharded"].to_local().numpy()
    full = {"kernel": torch.arange(64 * 32, dtype=torch.float32).view(64, 32),
            "bias": torch.arange(10, dtype=torch.float32)}
    sharded = fsdp.shard_params(full, "data", 0, mesh=mesh, transposed=("kernel",))
    out["shard_params_kernel"] = sharded["kernel"].to_local().numpy()
    out["shard_params_bias_is_dtensor"] = np.array(hasattr(sharded["bias"], "to_local"))
    back = fsdp.gather_params(sharded, "data")
    out["gather_params_equal"] = np.array(all(torch.equal(back[k], full[k]) for k in full))

    # (3) tiny GPT under build_train_functions (tests/test_gpt.py's _train):
    # AdamW(3e-3), a batch of 16 (4 rows per rank), one minibatch
    gparams = nested_tree("gparams", inputs)
    gbatch = _text_batch(inputs, "gbatch")
    local = gbatch.rows(4 * rank, 4 * rank + 4)

    def gpt_run(name, steps, **overrides):
        gcfg = tiny_test(**overrides)
        model = GPTLM(gcfg, device="cpu", mesh=mesh)
        funcs = build_train_functions(
            make_model_init(model, AdamW(lambda count: 3e-3)), make_gpt_loss(gcfg, mesh=mesh),
            mesh)
        state = funcs.init_fn(None, params_from_jax(gparams, gcfg, dtype=torch.float32))
        _locals(out, f"{name}_init", state.params)
        losses = []
        for _ in range(steps):
            state, metrics = funcs.step_fn(state, None, local)
            losses.append(compute(metrics)["loss"])
        out[f"{name}_losses"] = np.array(losses)
        out[f"{name}_specs"] = np.array(json.dumps(funcs.state_specs))
        return state

    gpt_run("gpt_dp", 4)
    gpt_run("gpt_fsdp", 8, fsdp=True, fsdp_min_size=0)
    # the gradients themselves (AdamW normalizes their scale away): one
    # accumulation in 2 minibatches and the sync, gathered, against one
    # process's gradient on the whole batch
    gcfg = tiny_test(fsdp=True, fsdp_min_size=0)
    model = GPTLM(gcfg, device="cpu", mesh=mesh)
    loss_fn = make_gpt_loss(gcfg, mesh=mesh)
    funcs = build_train_functions(make_model_init(model, AdamW(lambda count: 0.0)), loss_fn,
                                  mesh)
    state = funcs.init_fn(None, params_from_jax(gparams, gcfg, dtype=torch.float32))
    grads, _ = accumulate_gradients(state, local, state.rng, 2, loss_fn)
    fsdp.sync_gradients(state.partitioned(grads), ("data",), mesh=mesh)
    for name, g in export_single_device_params(state.partitioned(grads)).items():
        out[f"grad_fsdp/{name}"] = g.numpy().copy()
    single = GPTLM(tiny_test(), device="cpu")
    single.load_state_dict(params_from_jax(gparams, tiny_test(), dtype=torch.float32))
    make_gpt_loss(tiny_test())(single, gbatch)[0].backward()
    for name, p in single.named_parameters():
        out[f"grad_single/{name}"] = p.grad.numpy().copy()
    gpt_run("gpt_fsdp_chunk", 4, fsdp=True, fsdp_min_size=0, loss_chunk=16)

    # (4) the Trainer over data=4 from JAX's init, as tests/test_torch_dp.py
    # runs it, with fsdp: xla and flash; gathers and reduce-scatters per step
    tparams = nested_tree("tparams", inputs)
    example = _text_batch(inputs, "example")
    fsdp_kw = dict(fsdp=True, fsdp_min_size=0)
    for impl in ("xla", "flash"):
        trainer = Trainer(TrainerConfig(model="tiny", global_batch_size=8, num_minibatches=2,
                                        steps=4, warmup_steps=2,
                                        model_overrides=dict(attn_impl=impl, **fsdp_kw)),
                          mesh=mesh, device="cpu")
        tstate = trainer.init(params_from_jax(tparams, trainer.model_config,
                                              dtype=torch.float32))
        batch = trainer.local_rows(example)
        losses, counts = [], []
        for _ in range(4):
            before = (fsdp.fsdp_allgather_launches, fsdp.fsdp_reducescatter_launches,
                      dp.dp_allreduce_launches)
            tstate, metrics = trainer.step_fn(tstate, None, batch)
            counts.append([fsdp.fsdp_allgather_launches - before[0],
                           fsdp.fsdp_reducescatter_launches - before[1],
                           dp.dp_allreduce_launches - before[2]])
            losses.append(compute(metrics)["loss"])
        out[f"trainer_{impl}_losses"] = np.array(losses)
        out[f"trainer_{impl}_counts"] = np.array(counts)
        full = export_single_device_params(tstate.partitioned(tstate.params))
        for name, value in full.items():
            out[f"trainer_{impl}/{name}"] = value.numpy().copy()
        out[f"trainer_{impl}_replicated"] = np.array(sorted(
            n for n in tstate.params if n not in tstate.shards))
        for name in tstate.params:
            if name not in tstate.shards:
                out[f"trainer_{impl}_rep/{name}"] = tstate.params[name].numpy().copy()

    # (5) export: the FSDP state's full weights serve plain generate(), the
    # exported forward equals the mesh's, and a serving weight set's
    # fingerprint equals a replicated state's with the same weights
    ecfg = tiny_test(fsdp=True, fsdp_min_size=0)
    model = GPTLM(ecfg, device="cpu", mesh=mesh)
    funcs = build_train_functions(make_model_init(model, AdamW(lambda count: 1e-3)),
                                  make_gpt_loss(ecfg, mesh=mesh), mesh)
    estate = funcs.init_fn(None, params_from_jax(gparams, ecfg, dtype=torch.float32))
    exported = export_single_device_params(estate.partitioned(estate.params))
    single = GPTLM(ecfg, device="cpu")
    single.load_state_dict(exported)
    prompt = torch.zeros(1, 4, dtype=torch.long)
    out["export_tokens"] = generate(single, prompt, max_new_tokens=4).numpy()
    toks = torch.zeros(4, ecfg.seq_len, dtype=torch.long)
    with torch.no_grad():
        out["export_mesh_logits"] = model(toks[rank:rank + 1]).numpy()
        out["export_single_logits"] = single(toks[rank:rank + 1]).numpy()
    out["export_fingerprint"] = np.array(params_fingerprint(params_to_jax(exported, ecfg)))
    out["export_dp_fingerprint"] = np.array(params_fingerprint(params_to_jax(
        params_from_jax(gparams, ecfg, dtype=torch.float32), ecfg)))
    mesh22 = make_mesh(MeshConfig(data=2, model=2))
    split = [Shard(0) if n == "model" else Replicate() for n in mesh22.mesh_dim_names]
    try:
        export_single_device_params({"w": DTensor.from_local(torch.ones(2), mesh22, split)})
        out["export_model_split_error"] = np.array("")
    except ValueError as exc:
        out["export_model_split_error"] = np.array(str(exc))

    # (6) sharded checkpoints: save after 3 steps, restore bitwise into a
    # fresh Trainer, 2 more steps on both; max_to_keep; fit resumes
    ckpt_config = TrainerConfig(model="tiny", global_batch_size=8, steps=3, log_every=10,
                                model_overrides=dict(num_microbatches=2, **fsdp_kw))
    t1 = Trainer(ckpt_config, mesh=mesh, device="cpu")
    t1.init()
    t1.train(steps=3)
    ckpt_dir = os.path.join(outdir, "fsdp_ckpt")
    t1.save_checkpoint(ckpt_dir, step=t1.state.step)
    t2 = Trainer(ckpt_config, mesh=mesh, device="cpu")
    restored = t2.restore_checkpoint(ckpt_dir)
    out["ckpt_step"] = np.array(restored.step)
    out["ckpt_files"] = np.array(sorted(os.listdir(os.path.join(ckpt_dir, "3"))))
    same = [torch.equal(a, b) for a, b in zip(
        _tensor_leaves(t1.state.state_dict()), _tensor_leaves(restored.state_dict()))]
    out["ckpt_bitwise"] = np.array(all(same) and len(same) > 0)
    out["ckpt_module_bitwise"] = np.array(all(
        torch.equal(a, b) for a, b in zip(t1.model.parameters(), t2.model.parameters())))
    r1, r2 = t1.train(steps=2), t2.train(steps=2)
    out["ckpt_more_losses"] = np.array([r1["loss"], r2["loss"]])
    t3 = Trainer(TrainerConfig(model="tiny", global_batch_size=8, steps=3, ema_decay=0.9,
                               model_overrides=dict(num_microbatches=2, **fsdp_kw)),
                 mesh=mesh, device="cpu")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t3.restore_checkpoint(ckpt_dir)
    out["ckpt_ema_drift_warned"] = np.array(any("ema_params" in str(w.message) for w in caught))
    out["ckpt_ema_seeded_local"] = np.array(all(
        torch.equal(t3.state.ema_params[n], p) for n, p in t3.state.params.items()))
    fit_dir = os.path.join(outdir, "fsdp_fit")
    seen = []
    for steps in (4, 6):
        t = Trainer(TrainerConfig(model="tiny", global_batch_size=8, steps=steps, warmup_steps=1,
                                  model_overrides=fsdp_kw), mesh=mesh, device="cpu")
        real = t.step_fn
        t.step_fn = lambda s, m, b, real=real: (seen.append(s.step), real(s, m, b))[1]
        t.fit(fit_dir, checkpoint_every=1, max_to_keep=2)
    out["fit_steps_seen"] = np.array(seen)
    out["fit_dirs"] = np.array(sorted(os.listdir(fit_dir)))


def _tensor_leaves(tree):
    """The tensors of a state dict in a fixed order (local slices)."""
    found = []

    def walk(node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)
        elif hasattr(node, "to_local"):
            found.append(node.to_local())
        elif hasattr(node, "shape"):
            found.append(node)

    walk(tree)
    return found


def _assembled(out, prefix, tree, shards):
    """The full tensors of ``tree`` (a dict by parameter name, this rank's
    slices of the parameters in ``shards``), each slice all-gathered over
    its axis."""
    import torch
    import torch.distributed as dist

    for name, value in tree.items():
        value = value.to_local() if hasattr(value, "to_local") else value
        info = shards.get(name)
        if info is not None:
            parts = [torch.empty_like(value) for _ in range(info.size)]
            dist.all_gather(parts, value.contiguous(), group=info.group)
            value = torch.cat(parts, dim=info.dim)
        out[f"{prefix}/{name}"] = value.detach().float().numpy().copy()


def _tp_cases(inputs, outdir, out):
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F

    from tpu_parallel_torch.core.accumulate import accumulate_gradients
    from tpu_parallel_torch.core.losses import vocab_parallel_argmax, vocab_parallel_cross_entropy
    from tpu_parallel_torch.core.metrics import compute
    from tpu_parallel_torch.core.optim import AdamW, global_norm_sharded
    from tpu_parallel_torch.models import GPTLM, tiny_test
    from tpu_parallel_torch.models.convert import params_from_jax, params_to_jax
    from tpu_parallel_torch.models.generate import (_sample_sharded, export_single_device_params,
                                                    generate, generate_sharded)
    from tpu_parallel_torch.models.gpt import make_gpt_loss
    from tpu_parallel_torch.parallel import dp, fsdp, tp
    from tpu_parallel_torch.parallel.spmd import build_train_functions, make_model_init
    from tpu_parallel_torch.runtime import MeshConfig, make_mesh
    from tpu_parallel_torch.serving import Request, SchedulerConfig, ServingEngine
    from tpu_parallel_torch.serving.cache_pool import cache_partition_specs
    from tpu_parallel_torch.train_lib import Trainer, TrainerConfig

    mesh = make_mesh(MeshConfig(data=2, model=2))
    data, model = mesh.get_local_rank("data"), mesh.get_local_rank("model")
    out["coords"] = np.array([data, model])

    # (1) tests/test_tp.py's layers against the dense math on the assembled
    # weights (the inputs are replicated)
    gen = lambda: torch.Generator().manual_seed(0)
    x16 = torch.from_numpy(inputs["x16"].copy())
    col = tp.TPDense(16, 8, style="column", gather_output=True, mesh=mesh, generator=gen())
    row = tp.TPDense(16, 8, style="row", split_input=True, mesh=mesh, generator=gen())
    mlp = tp.TPMLP(12, 16, 12, mesh=mesh, generator=gen())
    with torch.no_grad():
        out["col_out"] = col(x16).numpy()
        out["row_out"] = row(x16).numpy()
        out["mlp_out"] = mlp(x16[:, :12]).numpy()
    for prefix, module in (("col", col), ("row", row), ("mlp", mlp)):
        params = dict(module.named_parameters())
        _assembled(out, f"{prefix}_w", params,
                   {n: fsdp.shard_info(p) for n, p in params.items() if fsdp.shard_info(p)})
        out[f"{prefix}_local_shape/weight"] = np.array(
            (module.up if prefix == "mlp" else module).weight.shape)
    # the gathered column's backward: (reduce-scatters, all-reduces,
    # all-gathers) it launches, and the assembled gradients
    counts = lambda: (tp.tp_reducescatter_launches, tp.tp_allreduce_launches,
                      tp.tp_allgather_launches)
    before = counts()
    (col(x16) * torch.from_numpy(inputs["col_cot"].copy())).sum().backward()
    out["col_gather_collectives"] = np.array([a - b for a, b in zip(counts(), before)])
    _assembled(out, "col_g", {n: p.grad for n, p in col.named_parameters()},
               {n: fsdp.shard_info(p) for n, p in col.named_parameters()})
    once = tp.TPDense(8, 4, style="row", split_input=True, mesh=mesh)
    with torch.no_grad():
        once.weight.zero_()
        once.bias.fill_(1.0)
        out["row_bias_once"] = once(torch.zeros(2, 8)).numpy()
    wide = tp.TPDense(256, 64, style="row", split_input=True, mesh=mesh, generator=gen())
    dense = tp.TPDense(256, 64, style="row", generator=gen())
    out["row_init_std"] = np.array([float(wide.weight.std()), float(dense.weight.std())])
    try:
        tp.split_over_axis(torch.zeros(2, 9), "model", mesh=mesh)
        out["split_error"] = np.array("")
    except ValueError as exc:
        out["split_error"] = np.array(str(exc))

    # (2) the vocab-parallel CE and argmax on this rank's columns of the
    # replicated logits, loss and gradients
    logits = torch.from_numpy(inputs["vp_logits"].copy()).requires_grad_(True)
    targets = torch.from_numpy(inputs["vp_targets"].copy()).long()
    ce, pred = vocab_parallel_cross_entropy(tp.split_over_axis(logits, "model", mesh=mesh),
                                            targets, "model", mesh)
    ce.sum().backward()
    out["vp_ce"] = ce.detach().numpy()
    out["vp_pred"] = pred.numpy()
    # rank-local gradient: tp x this rank's columns of the exact one
    out["vp_grad"] = logits.grad.numpy()
    tied = torch.zeros(3, 8)
    tied[:, [1, 6]] = 2.0
    out["vp_tie"] = vocab_parallel_argmax(tp.split_over_axis(tied, "model", mesh=mesh),
                                          "model", mesh).numpy()

    # (3) tests/test_tp.py:212: synced gradients against dense, and the two
    # planted faults (no division; a second division)
    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.pre = torch.nn.Linear(16, 16)
            self.up = tp.TPDense(16, 32, style="column", use_bias=False, mesh=mesh)
            self.down = tp.TPDense(32, 16, style="row", use_bias=False, mesh=mesh)

        def forward(self, x):
            return self.down(F.gelu(self.up(self.pre(x))))

    net = Net()
    with torch.no_grad():
        for name, p in net.named_parameters():
            full = torch.from_numpy(inputs[f"net/{name}"].copy())
            info = fsdp.shard_info(p)
            p.copy_(full if info is None else info.local(full))
    shards = {n: fsdp.shard_info(p) for n, p in net.named_parameters()
              if fsdp.shard_info(p) is not None}
    for variant, axes in (("good", ("model",)), ("no_div", ()), ("extra_div", ("model",))):
        net.zero_grad()
        (net(x16) ** 2).mean().backward()
        grads = {n: p.grad for n, p in net.named_parameters()}
        view = {n: shards[n].dtensor(g) if n in shards else g for n, g in grads.items()}
        fsdp.sync_gradients(view, ("data", "model"), replicated_loss_axes=axes, mesh=mesh)
        if variant == "extra_div":
            for n in shards:
                grads[n].div_(2.0)
        _assembled(out, f"net_grad_{variant}", grads, shards)

    # (4) tiny GPT: the synced gradients and the clip's norm against one
    # process, and the metrics on the model axis
    gparams = nested_tree("gparams", inputs)
    gbatch = _text_batch(inputs, "gbatch")
    local = gbatch.rows(4 * data, 4 * data + 4)
    gcfg = tiny_test()
    gmodel = GPTLM(gcfg, device="cpu", mesh=mesh)
    loss_fn = make_gpt_loss(gcfg, mesh=mesh)
    funcs = build_train_functions(make_model_init(gmodel, AdamW(lambda count: 0.0)), loss_fn,
                                  mesh, grad_sync_axes=("data", "model"))
    state = funcs.init_fn(None, params_from_jax(gparams, gcfg, dtype=torch.float32))
    grads, _ = accumulate_gradients(state, local, state.rng, 2, loss_fn)
    fsdp.sync_gradients(state.partitioned(grads), ("data", "model"), mesh=mesh)
    _assembled(out, "gpt_grad", grads, state.shards)
    out["gpt_grad_norm"] = np.array(float(global_norm_sharded(state.partitioned(grads))))
    single = GPTLM(gcfg, device="cpu")
    single.load_state_dict(params_from_jax(gparams, gcfg, dtype=torch.float32))
    loss, single_metrics = make_gpt_loss(gcfg)(single, gbatch)
    loss.backward()
    out["gpt_metrics_single"] = np.array([float(single_metrics["loss"][0]),
                                          float(single_metrics["loss"][1]),
                                          float(single_metrics["accuracy"][0])])
    for name, p in single.named_parameters():
        out[f"gpt_grad_single/{name}"] = p.grad.numpy().copy()
    state.zero_grads()
    losses = []
    for _ in range(2):
        state, metrics = funcs.step_fn(state, None, local)
        losses.append([float(metrics["loss"][0]), float(metrics["loss"][1]),
                       float(metrics["accuracy"][0])])
    out["gpt_metrics"] = np.array(losses)
    out["gpt_specs"] = np.array(json.dumps(funcs.state_specs))
    out["gpt_local_shapes"] = np.array(json.dumps(funcs.state_shapes))

    # (5) the Trainer over data=2 x model=2 from JAX's TP init: MHA and GQA,
    # xla and flash, 4 steps; per-step collectives; state slices
    for name in ("mha_xla", "mha_flash", "gqa_xla", "gqa_flash"):
        kind, impl = name.split("_")
        overrides = dict(attn_impl=impl, **({"n_kv_heads": 2} if kind == "gqa" else {}))
        trainer = Trainer(TrainerConfig(model="tiny", global_batch_size=8, num_minibatches=2,
                                        steps=4, warmup_steps=2, ema_decay=0.9,
                                        model_overrides=overrides),
                          mesh=mesh, device="cpu")
        tstate = trainer.init(params_from_jax(nested_tree(f"tparams_{name}", inputs),
                                              trainer.model_config, dtype=torch.float32))
        batch = trainer.local_rows(_text_batch(inputs, f"example_{name}"))
        losses, counts = [], []
        for _ in range(4):
            before = (tp.tp_allreduce_launches, dp.dp_allreduce_launches)
            tstate, metrics = trainer.step_fn(tstate, None, batch)
            counts.append([tp.tp_allreduce_launches - before[0],
                           dp.dp_allreduce_launches - before[1]])
            losses.append(compute(metrics)["loss"])
        out[f"trainer_{name}_losses"] = np.array(losses)
        out[f"trainer_{name}_counts"] = np.array(counts)
        _assembled(out, f"trainer_{name}", tstate.params, tstate.shards)
        if name == "mha_xla":
            shapes = {}
            for n in tstate.shards:
                mu = tstate.opt_state[1]["mu"][n]
                shapes[n] = [list(tstate.params[n].shape), list(mu.shape),
                             list(tstate.ema_params[n].shape), list(tstate.grads[n].shape),
                             list(tstate.shards[n].full_shape), tstate.shards[n].dim]
            out["trainer_shard_shapes"] = np.array(json.dumps(shapes))
            out["trainer_replicated"] = np.array(sorted(
                n for n in tstate.params if n not in tstate.shards))
            for n in tstate.params:
                if n not in tstate.shards:
                    out[f"trainer_rep/{n}"] = tstate.params[n].numpy().copy()
            try:
                export_single_device_params(tstate.partitioned(tstate.params))
                out["export_error"] = np.array("")
            except ValueError as exc:
                out["export_error"] = np.array(str(exc))
            # the mesh layout back to JAX: every model rank's slices
            local = {n: p.detach().float() for n, p in tstate.model.named_parameters()}
            ranks = [None] * 2
            for r in range(2):
                ranks[r] = {n: torch.empty_like(v) for n, v in local.items()}
            for n, v in local.items():
                parts = [torch.empty_like(v) for _ in range(2)]
                dist.all_gather(parts, v.contiguous(), group=mesh.get_group("model"))
                for r in range(2):
                    ranks[r][n] = parts[r]
            out.update(flat_tree("to_jax", params_to_jax(ranks, trainer.model_config)))

    # (6) remat policies: all-reduces per step over the model axis, and
    # the forward's alone
    for policy in ("full", "proj", "proj_attn", "dots"):
        trainer = Trainer(TrainerConfig(model="tiny", global_batch_size=8, steps=1,
                                        model_overrides=dict(remat_policy=policy)),
                          mesh=mesh, device="cpu")
        tstate = trainer.init(params_from_jax(nested_tree("tparams_mha_xla", inputs),
                                              trainer.model_config, dtype=torch.float32))
        batch = trainer.local_rows(_text_batch(inputs, "example_mha_xla"))
        before = tp.tp_allreduce_launches
        with torch.no_grad():
            trainer.loss_fn(tstate.model, batch, tstate.rng)
        fwd = tp.tp_allreduce_launches - before
        before = tp.tp_allreduce_launches
        tstate, metrics = trainer.step_fn(tstate, None, batch)
        out[f"remat_{policy}"] = np.array([fwd, tp.tp_allreduce_launches - before,
                                           compute(metrics)["loss"]])
    chunk = Trainer(TrainerConfig(model="tiny", global_batch_size=8, steps=2,
                                  model_overrides=dict(loss_chunk=8)), mesh=mesh, device="cpu")
    cstate = chunk.init(params_from_jax(nested_tree("tparams_mha_xla", inputs),
                                        chunk.model_config, dtype=torch.float32))
    batch = chunk.local_rows(_text_batch(inputs, "example_mha_xla"))
    out["chunk_losses"] = np.array([compute(chunk.step_fn(cstate, None, batch)[1])["loss"]
                                    for _ in range(2)])
    # FSDP x TP: the (5) Trainer's mha_xla run with fsdp=True, each TP
    # slice split again over data: JAX's TP trajectory from the same init
    trainer = Trainer(TrainerConfig(model="tiny", global_batch_size=8, num_minibatches=2,
                                    steps=4, warmup_steps=2, ema_decay=0.9,
                                    model_overrides=dict(fsdp=True, fsdp_min_size=0)),
                      mesh=mesh, device="cpu")
    tstate = trainer.init(params_from_jax(nested_tree("tparams_mha_xla", inputs),
                                          trainer.model_config, dtype=torch.float32))
    batch = trainer.local_rows(_text_batch(inputs, "example_mha_xla"))
    losses = []
    for _ in range(4):
        tstate, metrics = trainer.step_fn(tstate, None, batch)
        losses.append(compute(metrics)["loss"])
    out["fsdp_tp_losses"] = np.array(losses)
    out["fsdp_tp_nested"] = np.array(sum(
        len(info.axes) == 2 for info in tstate.shards.values()))
    for name, kw in (("heads", dict(n_heads=1, d_model=32)), ("kv", dict(n_kv_heads=1))):
        try:
            GPTLM(tiny_test(**kw), device="cpu", mesh=mesh)
            out[f"divisible_error_{name}"] = np.array("")
        except ValueError as exc:
            out[f"divisible_error_{name}"] = np.array(str(exc))

    # (7) generation under the mesh from JAX's TP init (fp32, no remat)
    gcfg = tiny_test(remat=False)
    sharded = GPTLM(gcfg, device="cpu", mesh=mesh)
    sharded.load_state_dict(params_from_jax(nested_tree("tparams_mha_xla", inputs), gcfg,
                                            model_rank=model))
    prompt = torch.from_numpy(inputs["gen_prompt"].copy()).long()
    mask = torch.from_numpy(inputs["gen_mask"].copy())
    out["gen_tokens"] = generate_sharded(sharded, prompt, max_new_tokens=8,
                                         prompt_mask=mask).numpy()
    dense = GPTLM(gcfg, device="cpu")
    dense.load_state_dict(params_from_jax(nested_tree("tparams_mha_xla", inputs), gcfg))
    out["gen_dense_tokens"] = generate(dense, prompt, max_new_tokens=8, prompt_mask=mask).numpy()
    for name, kw in (("topk", dict(top_k=5)), ("topp", dict(top_p=0.9)), ("temp", dict())):
        out[f"gen_{name}"] = generate_sharded(sharded, prompt, rng=torch.Generator().manual_seed(7),
                                              max_new_tokens=6, temperature=1.0, **kw).numpy()
    with torch.no_grad():
        out["gen_mesh_logits"] = sharded(prompt).numpy()
        out["gen_dense_logits"] = dense(prompt).numpy()
    # _sample_sharded on rows of one logit vector: greedy is the argmax,
    # top-k stays in the global top-k, every rank draws the same tokens
    row = torch.from_numpy(inputs["sample_logits"].copy())
    rows = row.expand(512, -1).contiguous()
    shard = tp.split_over_axis(rows, "model", mesh=mesh)
    g = torch.Generator().manual_seed(11)
    out["sample_greedy"] = _sample_sharded(shard, g, 0.0, 0, 0.0, "model", mesh).numpy()
    for name, (t, k, pp) in (("topk", (1.0, 4, 0.0)), ("temp", (1.0, 0, 0.0)),
                             ("topp", (1.0, 0, 0.8))):
        out[f"sample_{name}"] = _sample_sharded(shard, g, t, k, pp, "model", mesh).numpy()

    # (8) the engine over the mesh: greedy tokens against generate_sharded's
    # on the same prompts (a batch of 2, which the data axis divides)
    eprompt = torch.from_numpy(inputs["engine_prompt"].copy()).long()
    want = generate_sharded(sharded, eprompt, max_new_tokens=6)
    eng = ServingEngine(sharded, n_slots=2, mesh=mesh,
                        scheduler=SchedulerConfig(max_prefills_per_tick=2))
    outs = [eng.add_request(Request(prompt=eprompt[i].tolist(), max_new_tokens=6,
                                    request_id=f"r{i}")) for i in range(2)]
    eng.run()
    out["engine_tokens"] = np.array([o.tokens for o in outs])
    out["engine_want"] = want.numpy()
    out["engine_status"] = np.array([o.status for o in outs])
    out["engine_fused"] = np.array([eng.decode_steps_per_tick, int(eng.unified_tick),
                                    eng.graph_captures])
    out["engine_pool_heads"] = np.array(eng.pool.cache[0].key_heads.shape)
    out["engine_cache_specs"] = np.array(json.dumps(cache_partition_specs(sharded, mesh)))
    errors = []
    for kw in (dict(kv_block_tokens=8), dict(decode_steps_per_tick=4)):
        try:
            ServingEngine(sharded, n_slots=2, mesh=mesh, **kw)
            errors.append("")
        except NotImplementedError as exc:
            errors.append(str(exc))
    out["engine_errors"] = np.array(errors)
    # 8 requests of mixed lengths through 2 slots: each finishes at its budget
    lens = [3, 5, 7, 4, 6, 2, 8, 5]
    reqs = [eng.add_request(Request(prompt=[int(t) for t in eprompt[i % 2][:n]],
                                    max_new_tokens=4 + i % 3, request_id=f"m{i}"))
            for i, n in enumerate(lens)]
    eng.run()
    out["engine_mixed"] = np.array([[len(o.tokens), 4 + i % 3] for i, o in enumerate(reqs)])
    single_engine = ServingEngine(dense, n_slots=2, scheduler=SchedulerConfig(
        max_prefills_per_tick=2), decode_steps_per_tick=1)
    douts = [single_engine.add_request(Request(prompt=eprompt[i].tolist(), max_new_tokens=6,
                                               request_id=f"r{i}")) for i in range(2)]
    single_engine.run()
    out["engine_dense_tokens"] = np.array([o.tokens for o in douts])

    # (9) a model-sharded checkpoint: saved after 2 steps, restored bitwise
    # into a fresh Trainer, 2 more steps on both
    ckpt_config = TrainerConfig(model="tiny", global_batch_size=8, steps=2, log_every=10)
    t1 = Trainer(ckpt_config, mesh=mesh, device="cpu")
    t1.init()
    t1.train(steps=2)
    ckpt_dir = os.path.join(outdir, "tp_ckpt")
    t1.save_checkpoint(ckpt_dir, step=t1.state.step)
    t2 = Trainer(ckpt_config, mesh=mesh, device="cpu")
    restored = t2.restore_checkpoint(ckpt_dir)
    out["ckpt_step"] = np.array(restored.step)
    same = [torch.equal(a, b) for a, b in zip(
        _tensor_leaves(t1.state.state_dict()), _tensor_leaves(restored.state_dict()))]
    out["ckpt_bitwise"] = np.array(all(same) and len(same) > 0)
    out["ckpt_module_bitwise"] = np.array(all(
        torch.equal(a, b) for a, b in zip(t1.model.parameters(), t2.model.parameters())))
    out["ckpt_sharded_leaves"] = np.array(len(t1.state.shards))
    r1, r2 = t1.train(steps=2), t2.train(steps=2)
    out["ckpt_more_losses"] = np.array([r1["loss"], r2["loss"]])


def _pp_stage_modules():
    """``tests/test_pp.py``'s residual stage blocks (shape-preserving)."""
    import torch
    import torch.nn.functional as F
    from torch import nn

    class Block(nn.Module):
        def __init__(self):
            super().__init__()
            self.dense = nn.Linear(16, 16)

        def forward(self, x, train=True, dropout_rng=None):
            return x + F.silu(self.dense(x))

    class DropoutBlock(Block):
        def forward(self, x, train=True, dropout_rng=None):
            h = self.dense(x)
            if train:
                keep = torch.rand(h.shape, generator=dropout_rng) >= 0.5
                h = torch.where(keep, h / 0.5, torch.zeros_like(h))
            return x + h

    return Block, DropoutBlock


def _pp_rows(batch, mesh):
    """This rank's rows of a global batch: the block at its data coordinate."""
    d = mesh.get_local_rank("data")
    n = batch.size // mesh.size(mesh.mesh_dim_names.index("data"))
    return batch.rows(d * n, (d + 1) * n)


def _pp_cases(inputs, outdir, out):
    import torch
    import torch.nn.functional as F
    from torch import nn

    from tpu_parallel_torch.core.accumulate import accumulate_gradients
    from tpu_parallel_torch.core.metrics import compute, sync_metrics
    from tpu_parallel_torch.core.optim import AdamW
    from tpu_parallel_torch.core.state import Batch, TrainState
    from tpu_parallel_torch.models import GPTLM, tiny_test
    from tpu_parallel_torch.models.convert import params_from_jax
    from tpu_parallel_torch.models.generate import export_single_device_params, generate_sharded
    from tpu_parallel_torch.models.gpt import make_gpt_1f1b_grad_fn, make_gpt_loss
    from tpu_parallel_torch.parallel import fsdp, pp
    from tpu_parallel_torch.parallel.spmd import build_train_functions, make_model_init
    from tpu_parallel_torch.runtime import MeshConfig, make_mesh
    from tpu_parallel_torch.train_lib import Trainer, TrainerConfig

    Block, DropoutBlock = _pp_stage_modules()
    p4 = make_mesh(MeshConfig(data=2, pipe=4))
    m222 = make_mesh(MeshConfig(data=2, model=2, pipe=2))
    p2d4 = make_mesh(MeshConfig(data=4, pipe=2))
    out["coords_p4"] = np.array([p4.get_local_rank("pipe"), p4.get_local_rank("data")])
    out["coords_222"] = np.array([m222.get_local_rank(a) for a in ("pipe", "data", "model")])
    out["coords_p2d4"] = np.array([p2d4.get_local_rank("pipe"), p2d4.get_local_rank("data")])

    # (1) tests/test_pp.py's generic pipeline on data=2 x pipe=4
    x = torch.from_numpy(inputs["pp_x"].copy())
    d = p4.get_local_rank("data")
    x_local = x[4 * d:4 * d + 4]
    pm = pp.PipelineModule(Block, 4, mesh=p4, broadcast_outputs=True)
    with torch.no_grad():
        out["fwd_out"] = pm(x_local).numpy()
    out["fwd_w"] = pm.stage.dense.weight.detach().numpy().copy()
    out["fwd_b"] = pm.stage.dense.bias.detach().numpy().copy()
    out["fwd_stage_tagged"] = np.array(all(pp.stage_info(p) is not None for p in pm.parameters()))
    dm = pp.PipelineModule(DropoutBlock, 4, mesh=p4, broadcast_outputs=True)
    with torch.no_grad():
        a = dm(x_local, train=False, dropout_rng=torch.Generator().manual_seed(1))
        b = dm(x_local, train=False, dropout_rng=torch.Generator().manual_seed(2))
        c = dm(x_local, train=True, dropout_rng=torch.Generator().manual_seed(1))
    out["kwargs_eval_equal"] = np.array(torch.equal(a, b))
    out["kwargs_train_differs"] = np.array(not torch.equal(a, c))
    try:
        pp.PipelineModule(Block, 3, mesh=p4)(x_local)
        out["indivisible_error"] = np.array("")
    except ValueError as exc:
        out["indivisible_error"] = np.array(str(exc))

    class Classifier(nn.Module):
        def __init__(self):
            super().__init__()
            torch.manual_seed(0)
            self.embed = nn.Linear(16, 16)
            self.pipeline = pp.PipelineModule(Block, 4, mesh=p4)
            self.head = nn.Linear(16, 10)

        def forward(self, inputs):
            return self.head(self.pipeline(self.embed(inputs)))

    def cls_loss(model, batch, rng=None):
        logits = model(batch.inputs)
        ce = F.cross_entropy(logits, batch.labels, reduction="none")
        mask = pp.last_stage_mask(p4)
        correct = (logits.argmax(-1) == batch.labels).float()
        bs = torch.tensor(float(batch.labels.numel()))
        metrics = {"loss": ((ce * mask).sum().detach(), bs * mask),
                   "accuracy": ((correct * mask).sum(), bs * mask)}
        return (ce * mask).mean(), metrics

    cls_batch = Batch(inputs=torch.from_numpy(inputs["cls_inputs"].copy()),
                      labels=torch.from_numpy(inputs["cls_labels"].copy()).long())
    cls_local = _pp_rows(cls_batch, p4)
    clf = Classifier()
    funcs = build_train_functions(make_model_init(clf, AdamW(lambda count: 1e-3)), cls_loss, p4,
                                  grad_sync_axes=("data",), grad_psum_axes=("pipe",),
                                  metric_axes=("data", "pipe"))
    state = funcs.init_fn(torch.Generator().manual_seed(0))
    losses = []
    for step in range(16):
        state, m = funcs.step_fn(state, None, cls_local)
        losses.append(compute(m)["loss"])
        if step == 4:
            out["cls_embed_after5"] = state.params["embed.weight"].numpy().copy()
            out["cls_head_after5"] = state.params["head.weight"].numpy().copy()
    out["cls_losses"] = np.array(losses)
    out["cls_count"] = np.array(float(m["loss"][1]))

    # (2) the tiny GPT from JAX's GPipe init on data=2 x pipe=4: GPipe and
    # 1F1B synced gradients, with and without FSDP; collectives per step
    def load(cfg, mesh, prefix, **kw):
        tree = nested_tree(prefix, inputs)
        stage = pp.pipe_axis(mesh)
        params = params_from_jax(tree, cfg, dtype=torch.float32,
                                 pipe_rank=None if stage is None else stage[2])
        model = GPTLM(cfg, device="cpu", mesh=mesh)
        return TrainState.create(model, AdamW(lambda count: 1e-3),
                                 torch.Generator().manual_seed(0), params)

    def synced(state, grads, mesh, prefix, replicated_loss_axes=("model",)):
        fsdp.sync_gradients(state.partitioned(grads), ("data", "model"), ("pipe",),
                            replicated_loss_axes=replicated_loss_axes, mesh=mesh)
        _assembled(out, prefix, grads, state.shards)

    gbatch = _text_batch(inputs, "gbatch")
    for fsdp_on in (False, True):
        over = dict(fsdp=True, fsdp_min_size=0) if fsdp_on else {}
        for sched in ("gpipe", "1f1b"):
            cfg = tiny_test(pipe_size=4, num_microbatches=4, remat=False, pipe_schedule=sched,
                            **over)
            st = load(cfg, p4, "g4params")
            b = _pp_rows(gbatch, p4)
            before = (pp.pp_send_launches, pp.pp_recv_launches)
            if sched == "gpipe":
                grads, met = accumulate_gradients(st, b, st.rng, 1, make_gpt_loss(cfg, mesh=p4))
                # each microbatch's stage gradients were folded into their
                # fp32 accumulators as the reverse schedule ran
                out[f"folded_{fsdp_on}"] = np.array(
                    all(p.grad is None for p in st.model.blocks.parameters()))
            else:
                grads, met = make_gpt_1f1b_grad_fn(cfg, mesh=p4)(st, b, st.rng)
            tag = f"{sched}{'_fsdp' if fsdp_on else ''}"
            out[f"p2p_{tag}"] = np.array([pp.pp_send_launches - before[0],
                                          pp.pp_recv_launches - before[1]])
            met = sync_metrics(met, ("data", "pipe"), mesh=p4)
            out[f"loss_{tag}"] = np.array([float(met["loss"][0]), float(met["loss"][1])])
            synced(st, grads, p4, f"g_{tag}")
            if not fsdp_on and sched == "gpipe":
                try:
                    export_single_device_params(st.partitioned(st.params))
                    out["export_error"] = np.array("")
                except ValueError as exc:
                    out["export_error"] = np.array(str(exc))

    # (3) the deep 1F1B schedule: pipe=4, 12 microbatches; a ring too small
    # for rank 1's 2n - 4 ticks of lag (planted) must be grossly wrong
    dbatch = _pp_rows(_text_batch(inputs, "dbatch"), p4)
    for name in ("gpipe", "1f1b", "1f1b_small_ring"):
        cfg = tiny_test(pipe_size=4, num_microbatches=12, remat=False)
        st = load(cfg, p4, "g4params")
        if name == "gpipe":
            grads, _ = accumulate_gradients(st, dbatch, st.rng, 1, make_gpt_loss(cfg, mesh=p4))
        else:
            real = pp._ring_slots
            if name == "1f1b_small_ring":
                pp._ring_slots = lambda n: 2 * n - 4
            try:
                grads, _ = make_gpt_1f1b_grad_fn(cfg, mesh=p4)(st, dbatch, st.rng)
            finally:
                pp._ring_slots = real
        synced(st, grads, p4, f"deep_{name}")

    # (4) the interleaved schedule (pipe=2 x 2 virtual stages, data=4) from
    # JAX's interleaved init: the forward against one process's on the
    # same weights, and the synced gradients
    cfg_i = tiny_test(pipe_size=2, pipe_interleave=2, num_microbatches=2, remat=False)
    st = load(cfg_i, p2d4, "iparams")
    out["inter_layer_ids"] = np.array(st.model.blocks.layer_ids)
    b = _pp_rows(gbatch, p2d4)
    with torch.no_grad():
        logits = st.model(b.tokens, positions=b.positions)
    one = GPTLM(tiny_test(remat=False), device="cpu")
    one.load_state_dict(params_from_jax(nested_tree("iparams", inputs), cfg_i))
    with torch.no_grad():
        want = one(b.tokens, positions=b.positions)
    if st.model.is_last_stage:
        out["inter_fwd_err"] = np.array(float((logits - want).abs().max()))
    grads, _ = accumulate_gradients(st, b, st.rng, 1, make_gpt_loss(cfg_i, mesh=p2d4))
    synced(st, grads, p2d4, "g_inter")
    for name, value in st.model.state_dict().items():
        out[f"inter_sd/{name}"] = value.numpy().copy()

    # (5) packed == unpacked at interleave 1 and 2 (data=2 x model=2 x pipe=2);
    # packed leakage blocked (data=2 x pipe=4)
    def mean_loss(cfg, mesh, st, batch):
        with torch.no_grad():
            _, met = make_gpt_loss(cfg, mesh=mesh)(st.model, _pp_rows(batch, mesh), None)
        met = sync_metrics(met, ("data", "pipe"), ("model",), mesh=mesh)
        return float(met["loss"][0]) / float(met["loss"][1])

    packed, unpacked = _text_batch(inputs, "packed"), _text_batch(inputs, "unpacked")
    for v in (1, 2):
        cfg = tiny_test(pipe_size=2, pipe_interleave=v, num_microbatches=2, remat=False)
        model = GPTLM(cfg, device="cpu", seed=5, mesh=m222)
        st = TrainState.create(model, AdamW(lambda count: 1e-3), torch.Generator())
        out[f"packed_{v}"] = np.array([mean_loss(cfg, m222, st, packed),
                                       mean_loss(cfg, m222, st, unpacked)])
    cfg = tiny_test(pipe_size=4, num_microbatches=2, remat=False)
    st = TrainState.create(GPTLM(cfg, device="cpu", seed=5, mesh=p4), AdamW(lambda c: 1e-3),
                           torch.Generator())
    leak = _text_batch(inputs, "leak")
    perturbed = _text_batch(inputs, "leak")
    perturbed.tokens = torch.from_numpy(inputs["leak_perturbed"].copy()).long()
    out["leak"] = np.array([mean_loss(cfg, p4, st, leak), mean_loss(cfg, p4, st, perturbed)])

    # (6) the gradient scale under TP x PP (data=2 x model=2 x pipe=2): the
    # synced gradients against one process's dense ones; a planted missing
    # division by the model axis, and a planted extra one
    tbatch = _text_batch(inputs, "example_3d")
    cfg = tiny_test(pipe_size=2, num_microbatches=2, remat=False)
    for name, axes in (("good", ("model",)), ("no_div", ()), ("extra_div", ("model",))):
        st = load(cfg, m222, "tparams")
        grads, _ = accumulate_gradients(st, _pp_rows(tbatch, m222), st.rng, 1,
                                        make_gpt_loss(cfg, mesh=m222))
        if name == "extra_div":
            torch._foreach_div_([grads[n] for n in st.shards], 2.0)
        synced(st, grads, m222, f"scale_{name}", replicated_loss_axes=axes)
    dense = GPTLM(tiny_test(remat=False), device="cpu")
    dense_state = TrainState.create(dense, AdamW(lambda count: 1e-3), torch.Generator(),
                                    params_from_jax(nested_tree("tparams", inputs),
                                                    tiny_test(), dtype=torch.float32))
    grads, _ = accumulate_gradients(dense_state, tbatch, dense_state.rng, 1,
                                    make_gpt_loss(tiny_test()))
    for name, value in grads.items():
        out[f"scale_dense/{name}"] = value.numpy().copy()

    # (7) generate_sharded over data=2 x model=2 x pipe=2 (greedy, ragged;
    # then sampled), and the decode ring's prefill against the training
    # forward (data=2 x pipe=4)
    gcfg = tiny_test(pipe_size=2, remat=False)
    gen_model = load(gcfg, m222, "tparams").model
    prompt = torch.from_numpy(inputs["gen_prompt"].copy()).long()
    mask = torch.from_numpy(inputs["gen_mask"].copy())
    out["gen_greedy"] = generate_sharded(gen_model, prompt, max_new_tokens=8,
                                         prompt_mask=mask).numpy()
    out["gen_sampled"] = generate_sharded(gen_model, prompt, rng=torch.Generator().manual_seed(3),
                                          max_new_tokens=8, temperature=1.0,
                                          prompt_mask=mask).numpy()
    with torch.no_grad():
        out["full_logits_shape"] = np.array(gen_model(prompt).shape)
    cfg = tiny_test(pipe_size=4, remat=False)
    model = load(cfg, p4, "g4params").model
    toks = _pp_rows(gbatch, p4).tokens[:, :8]
    positions = torch.arange(8).expand_as(toks)
    with torch.no_grad():
        train_logits = model(toks)
        cache = model.init_cache(toks.shape[0])
        prefill = model(toks, positions=positions, decode=True, cache=cache)
    out["prefill_last_stage"] = np.array(model.is_last_stage)
    out["prefill_err"] = np.array(float((train_logits - prefill).abs().max()))
    out["prefill_cache_layers"] = np.array(len(cache))

    # (8) tests/test_train_lib.py::test_trainer_tiny_3d: the Trainer over
    # data=2 x model=2 x pipe=2 from JAX's init, 4 steps on JAX's batch
    kw = dict(model="tiny", model_overrides=dict(num_microbatches=2),
              mesh=dict(data=2, model=2, pipe=2), global_batch_size=16, steps=4, log_every=1)
    t3 = Trainer(TrainerConfig(**kw), device="cpu")
    out["trainer_pipe_size"] = np.array(t3.model_config.pipe_size)
    t3.init(params_from_jax(nested_tree("tparams", inputs), t3.model_config, dtype=torch.float32,
                            pipe_rank=m222.get_local_rank("pipe")))
    state, losses = t3.state, []
    before = (pp.pp_send_launches, pp.pp_recv_launches)
    for _ in range(4):
        state, m = t3.step_fn(state, None, t3.local_rows(tbatch))
        losses.append(compute(m)["loss"])
    out["trainer_losses"] = np.array(losses)
    out["trainer_p2p_per_step"] = np.array([(pp.pp_send_launches - before[0]) / 4,
                                            (pp.pp_recv_launches - before[1]) / 4])
    out["trainer_num_params"] = np.array(t3.num_params)

    # (9) a PP checkpoint: saved after 2 steps, restored bitwise into a
    # fresh Trainer, 2 more steps on both
    ck = TrainerConfig(**{**kw, "steps": 2})
    t1 = Trainer(ck, device="cpu")
    t1.init()
    t1.train(steps=2)
    ckpt_dir = os.path.join(outdir, "pp_ckpt")
    t1.save_checkpoint(ckpt_dir, step=t1.state.step)
    t2 = Trainer(ck, device="cpu")
    restored = t2.restore_checkpoint(ckpt_dir)
    out["ckpt_step"] = np.array(restored.step)
    same = [torch.equal(a, b) for a, b in zip(
        _tensor_leaves(t1.state.state_dict()), _tensor_leaves(restored.state_dict()))]
    out["ckpt_bitwise"] = np.array(all(same) and len(same) > 0)
    out["ckpt_keys"] = np.array(sorted(t1.state.params))
    r1, r2 = t1.train(steps=2), t2.train(steps=2)
    out["ckpt_more_losses"] = np.array([r1["loss"], r2["loss"]])

    # (10) 1F1B in bf16 through the Trainer (tests/test_pp.py:716)
    bf = Trainer(TrainerConfig(model="tiny", model_overrides=dict(
        num_microbatches=4, dtype=torch.bfloat16, remat=False, pipe_schedule="1f1b"),
        mesh=dict(data=2, model=2, pipe=2), global_batch_size=8, steps=2, log_every=1000),
        device="cpu")
    bf.init()
    out["bf16_1f1b_loss"] = np.array(bf.train(steps=2)["loss"])


# -- sequence parallelism (tests/test_torch_sp.py) ---------------------------

# op cases: name -> (op, (batch, seq, heads, kv heads, head_dim), kwargs,
# packed segment ids, gradients, mesh (data, seq)); each rank runs its seq
# block, the test holds it to JAX's op on the same mesh
SP_OP_CASES = {
    "ring_plain": ("ring", (2, 128, 2, 2, 32), {}, False, False, (2, 4)),
    "ring_plain_grad": ("ring", (1, 64, 2, 2, 16), {}, False, True, (2, 4)),
    "ring_flash": ("ring_flash", (2, 128, 2, 2, 32), {}, False, False, (2, 4)),
    "ring_flash_grad": ("ring_flash", (1, 64, 2, 2, 16), {}, False, True, (2, 4)),
    **{f"ring_plain_window{w}": ("ring", (2, 128, 2, 2, 32), dict(window=w), False, False, (2, 4))
       for w in (16, 32, 100, 1000)},
    **{f"ring_flash_window{w}": ("ring_flash", (1, 256, 2, 2, 32), dict(window=w), False, False,
                                 (2, 4)) for w in (24, 100, 1000)},
    "ring_flash_window_grad": ("ring_flash", (1, 128, 2, 2, 16), dict(window=40), False, True,
                               (2, 4)),
    "ring_plain_packed": ("ring", (1, 128, 2, 2, 16), {}, True, True, (2, 4)),
    "ring_flash_packed": ("ring_flash", (1, 128, 2, 2, 16), {}, True, True, (2, 4)),
    "ring_plain_gqa": ("ring", (1, 128, 4, 2, 16), {}, False, True, (2, 4)),
    "ring_flash_gqa": ("ring_flash", (1, 128, 4, 2, 16), {}, False, True, (2, 4)),
    **{f"ring_plain_bidir_window{w}": ("ring", (2, 128, 2, 2, 32), dict(window=w, causal=False),
                                       False, False, (2, 4)) for w in (16, 32, 100, 1000)},
    **{f"ring_flash_bidir_window{w}": ("ring_flash", (1, 256, 2, 2, 32),
                                       dict(window=w, causal=False), False, False, (2, 4))
       for w in (24, 100, 1000)},
    "ring_flash_bidir_window_grad": ("ring_flash", (1, 128, 2, 2, 16),
                                     dict(window=40, causal=False), False, True, (2, 4)),
    "ring_flash_bidir_grad": ("ring_flash", (1, 128, 2, 2, 16), dict(causal=False), True, True,
                              (2, 4)),
    "ulysses": ("ulysses", (2, 128, 4, 4, 32), {}, False, False, (2, 4)),
    "ulysses_grad": ("ulysses", (1, 64, 4, 4, 16), {}, False, True, (2, 4)),
    "ulysses_gqa2": ("ulysses", (1, 128, 8, 2, 16), {}, False, True, (2, 4)),
    "ulysses_gqa4": ("ulysses", (1, 128, 8, 4, 16), {}, False, True, (2, 4)),
}
# model cases trained over a seq mesh: name -> (model overrides, mesh)
SP_TRAINERS = {
    "ring": (dict(attn_impl="ring", seq_len=64), dict(data=2, seq=4)),
    "ulysses": (dict(attn_impl="ulysses", seq_len=64), dict(data=2, seq=4)),
}
SP_TRAINER_3D = (dict(attn_impl="ring", seq_len=64), dict(data=2, seq=2, model=2))
SP_VARIANTS = {
    "ring_window": (dict(attn_impl="ring", seq_len=64, attn_window=24), dict(data=2, seq=4)),
    "ring_packed": (dict(attn_impl="ring", seq_len=64), dict(data=2, seq=4)),
    "ring_gqa": (dict(attn_impl="ring", seq_len=64, n_kv_heads=2), dict(data=2, seq=4)),
    "ulysses_window": (dict(attn_impl="ulysses", seq_len=64, attn_window=24),
                       dict(data=4, seq=2)),
    "ulysses_packed": (dict(attn_impl="ulysses", seq_len=64), dict(data=2, seq=4)),
    "ulysses_gqa": (dict(attn_impl="ulysses", seq_len=64, n_heads=8, n_kv_heads=4),
                    dict(data=2, seq=4)),
}
SP_VARIANT_STEPS = 6


def _sp_counts():
    from tpu_parallel_torch.ops import ring_attention, ulysses
    from tpu_parallel_torch.parallel import dp

    return [dp.dp_allreduce_launches, ring_attention.sp_ring_send_launches,
            ring_attention.sp_ring_recv_launches, ulysses.sp_alltoall_launches]


def _sp_cases(inputs, outdir, out):
    import torch

    from tpu_parallel_torch.core.accumulate import accumulate_gradients
    from tpu_parallel_torch.core.metrics import compute
    from tpu_parallel_torch.data import DataLoader, TokenDataset, make_global_batch
    from tpu_parallel_torch.models import GPTLM, layers, tiny_test
    from tpu_parallel_torch.models.convert import params_from_jax
    from tpu_parallel_torch.ops.ring_attention import ring_attention, ring_flash_attention
    from tpu_parallel_torch.ops.ulysses import ulysses_attention
    from tpu_parallel_torch.parallel import fsdp
    from tpu_parallel_torch.runtime import MeshConfig, make_mesh
    from tpu_parallel_torch.train_lib import Trainer, TrainerConfig

    meshes = {}

    def mesh_of(sizes):
        key = tuple(sorted(sizes.items()))
        if key not in meshes:
            meshes[key] = make_mesh(MeshConfig(**sizes))
        return meshes[key]

    # (0) the groups an all-reduce over data, seq and model runs on: the
    # token axes' joint ranks (made with the mesh), then the model axis
    from tpu_parallel_torch.runtime.mesh import reduction_groups

    for key, sizes in (("token_group_sizes", dict(data=2, seq=4)),
                       ("token_group_sizes_3d", dict(data=2, seq=2, model=2))):
        groups = reduction_groups(mesh_of(sizes), ("data", "seq", "model"))
        out[key] = np.array([size for _, size in groups])
    ops = dict(ring=ring_attention, ring_flash=ring_flash_attention, ulysses=ulysses_attention)
    # (1) the ops, each rank on its seq block
    for name, (op, shape, kw, packed, grad, (data, seq)) in SP_OP_CASES.items():
        mesh = mesh_of(dict(data=data, seq=seq))
        c = mesh.get_local_rank("seq")
        n = shape[1] // seq
        blk = slice(c * n, (c + 1) * n)
        q, k, v = (torch.from_numpy(inputs[f"op_{name}/{x}"][:, blk].copy()).requires_grad_(grad)
                   for x in "qkv")
        if packed:
            kw = dict(kw, segment_ids=torch.from_numpy(inputs[f"op_{name}/seg"][:, blk].copy()))
        got = ops[op](q, k, v, mesh=mesh, **kw)
        out[f"op_{name}/out"] = got.detach().numpy()
        if grad:
            (got.float() ** 2).sum().backward()
            for x, t in zip("qkv", (q, k, v)):
                out[f"op_{name}/d{x}"] = t.grad.numpy()
    out["seq_coord"] = np.array(mesh_of(dict(data=2, seq=4)).get_local_rank("seq"))
    out["seq_coord_42"] = np.array(mesh_of(dict(data=4, seq=2)).get_local_rank("seq"))
    try:
        q = torch.zeros(1, 16, 3, 16)
        ulysses_attention(q, q, q, mesh=mesh_of(dict(data=2, seq=4)))
        out["ulysses_indivisible"] = np.array("")
    except ValueError as exc:
        out["ulysses_indivisible"] = np.array(str(exc))

    # (2) JAX's Trainer over data=2 x seq=4: 4 steps from JAX's init, the
    # collectives per step, the final masters; the step-1 synced gradients
    for name, (overrides, sizes) in SP_TRAINERS.items():
        mesh = mesh_of(sizes)
        for policy in ("full", "proj_attn"):
            trainer = Trainer(TrainerConfig(model="tiny", global_batch_size=8, num_minibatches=2,
                                            steps=4, warmup_steps=2,
                                            model_overrides=dict(overrides, remat_policy=policy)),
                              mesh=mesh, device="cpu")
            state = trainer.init(params_from_jax(nested_tree(f"tparams_{name}", inputs),
                                                 trainer.model_config, dtype=torch.float32))
            batch = trainer.local_rows(_text_batch(inputs, f"example_{name}"))
            if policy == "full":
                grads, _ = accumulate_gradients(state, batch, state.rng, 1, trainer.loss_fn)
                fsdp.sync_gradients(state.partitioned(grads), ("data", "seq", "model"),
                                    mesh=mesh)
                for key, value in grads.items():
                    out[f"trainer_{name}_grads/{key}"] = value.numpy().copy()
                state.zero_grads()
            losses, counts = [], []
            for _ in range(4):
                before = _sp_counts()
                state, metrics = trainer.step_fn(state, None, batch)
                counts.append([a - b for a, b in zip(_sp_counts(), before)])
                losses.append(compute(metrics)["loss"])
            out[f"trainer_{name}_{policy}_losses"] = np.array(losses)
            out[f"trainer_{name}_{policy}_counts"] = np.array(counts)
            _masters(out, f"trainer_{name}_{policy}", state)
        out[f"trainer_{name}_batch_spec"] = np.array(trainer.batch_spec)

    # (3) the flash-composed ring inside the model (the dispatch a CUDA
    # tensor takes), under both policies: losses as the plain ring's, and
    # its hops per step (the proj_attn recompute neither exchanges nor
    # launches)
    plain = layers.ring_attention
    layers.ring_attention = ring_flash_attention
    try:
        overrides, sizes = SP_TRAINERS["ring"]
        for policy in ("full", "proj_attn"):
            trainer = Trainer(TrainerConfig(model="tiny", global_batch_size=8, num_minibatches=2,
                                            steps=4, warmup_steps=2,
                                            model_overrides=dict(overrides, remat_policy=policy)),
                              mesh=mesh_of(sizes), device="cpu")
            state = trainer.init(params_from_jax(nested_tree("tparams_ring", inputs),
                                                 trainer.model_config, dtype=torch.float32))
            batch = trainer.local_rows(_text_batch(inputs, "example_ring"))
            losses, counts = [], []
            for _ in range(2):
                before = _sp_counts()
                state, metrics = trainer.step_fn(state, None, batch)
                counts.append([a - b for a, b in zip(_sp_counts(), before)])
                losses.append(compute(metrics)["loss"])
            out[f"ring_flash_model_{policy}_losses"] = np.array(losses)
            out[f"ring_flash_model_{policy}_counts"] = np.array(counts)
    finally:
        layers.ring_attention = plain

    # (4) tests/test_train_lib.py's Trainer over data=2 x seq=2 x model=2
    overrides, sizes = SP_TRAINER_3D
    trainer = Trainer(TrainerConfig(model="tiny", model_overrides=overrides, mesh=sizes,
                                    global_batch_size=8, steps=6, log_every=6,
                                    learning_rate=1e-2), device="cpu")
    state = trainer.init(params_from_jax(nested_tree("tparams_3d", inputs), trainer.model_config,
                                         dtype=torch.float32))
    batch = trainer.local_rows(_text_batch(inputs, "example_3d"))
    losses, counts = [], []
    for _ in range(6):
        before = _sp_counts()
        state, metrics = trainer.step_fn(state, None, batch)
        counts.append([a - b for a, b in zip(_sp_counts(), before)])
        losses.append(compute(metrics)["loss"])
    out["trainer_3d_losses"] = np.array(losses)
    out["trainer_3d_counts"] = np.array(counts)
    out["trainer_3d_batch_spec"] = np.array(trainer.batch_spec)
    out["trainer_3d_num_params"] = np.array(trainer.num_params)
    result = trainer.train(steps=2)
    out["trainer_3d_train"] = np.array([result["loss"], result["accuracy"]])

    # (5) tests/test_ring_attention.py's and test_ulysses.py's training
    # variants: the step-1 loss and synced gradients, then a falling loss
    for name, (overrides, sizes) in SP_VARIANTS.items():
        trainer = Trainer(TrainerConfig(model="tiny", model_overrides=overrides, mesh=sizes,
                                        global_batch_size=8, steps=SP_VARIANT_STEPS,
                                        warmup_steps=0, lr_schedule="constant",
                                        learning_rate=3e-3, weight_decay=1e-4),
                          device="cpu")
        state = trainer.init(params_from_jax(nested_tree(f"vparams_{name}", inputs),
                                             trainer.model_config, dtype=torch.float32))
        batch = trainer.local_rows(_text_batch(inputs, f"vbatch_{name}"))
        grads, metrics = accumulate_gradients(state, batch, state.rng, 1, trainer.loss_fn)
        fsdp.sync_gradients(state.partitioned(grads), ("data", "seq", "model"),
                            mesh=trainer.mesh)
        for key, value in grads.items():
            out[f"variant_{name}_grads/{key}"] = value.numpy().copy()
        state.zero_grads()
        losses = []
        for _ in range(SP_VARIANT_STEPS):
            state, metrics = trainer.step_fn(state, None, batch)
            losses.append(compute(metrics)["loss"])
        out[f"variant_{name}_losses"] = np.array(losses)
        out[f"variant_{name}_tokens"] = np.array(float(metrics["loss"][1]))

    # (6) a bare forward on the seq block (positions offset by the seq
    # coordinate), JAX's refusals, the loader's token blocks
    mesh = mesh_of(dict(data=2, seq=4))
    c = mesh.get_local_rank("seq")
    model = GPTLM(tiny_test(attn_impl="ring", seq_len=64), device="cpu", mesh=mesh)
    model.load_state_dict(params_from_jax(nested_tree("vparams_ring_packed", inputs),
                                          model.config))
    tokens = torch.from_numpy(inputs["vbatch_ring_packed/tokens"][:, 16 * c:16 * c + 16].copy())
    with torch.no_grad():
        out["bare_logits"] = model(tokens.long()).numpy()
        try:
            model(tokens.long()[:, :1], decode=True, cache=model.init_cache(8))
            out["decode_refusal"] = np.array("")
        except NotImplementedError as exc:
            out["decode_refusal"] = np.array(str(exc))
    try:
        Trainer(TrainerConfig(model="tiny", mesh=dict(data=4, seq=2), global_batch_size=8),
                device="cpu")
        out["dense_refusal"] = np.array("")
    except ValueError as exc:
        out["dense_refusal"] = np.array(str(exc))
    ds = TokenDataset(inputs["loader_tokens"], 64)
    loader = DataLoader(ds, 8, seed=3, device="cpu", process_count=2,
                        process_index=mesh.get_local_rank("data"), seq_count=4, seq_index=c)
    for step in range(2):
        local = loader.batch_at(step)
        glob = make_global_batch(local, mesh, ("data", "seq"))
        for field in ("tokens", "targets", "positions"):
            out[f"loader_{step}_{field}"] = getattr(glob, field).full_tensor().numpy()
            out[f"loader_{step}_local_{field}"] = getattr(local, field).numpy()


def _load_full(model, params):
    """Copy full-shape ``params`` (by name) into ``model``, each sharded
    parameter taking this rank's slice."""
    import torch

    from tpu_parallel_torch.parallel import fsdp

    with torch.no_grad():
        for name, p in model.named_parameters():
            full = params[name]
            info = fsdp.shard_info(p)
            p.copy_(full if info is None else info.local(full))


def _moe_state(tree):
    """A ``MoEMLP``'s full state dict from JAX's one-device ``MoEMLP``
    params (``router/kernel``, ``experts/{up,down}/{kernel,bias}``)."""
    import torch

    state = {"router.weight": torch.from_numpy(tree["router"]["kernel"].T.copy())}
    for name in ("up", "down"):
        for leaf in ("kernel", "bias"):
            state[f"experts.{name}.{leaf}"] = torch.from_numpy(
                tree["experts"][name][leaf].copy())
    return state


# the routing kinds of tests/test_moe.py's EP cases: (config overrides,
# capacity factor)
MOE_EP_KINDS = {"top1": dict(moe_capacity_factor=4.0),
                "top2": dict(moe_top_k=2, moe_capacity_factor=8.0),
                "ec": dict(moe_router="expert_choice", moe_capacity_factor=2.0)}
# tests/test_moe.py's training cases: (mesh, model overrides, steps, the
# inputs' prefix of JAX's init)
MOE_TRAIN_CASES = {
    "dp_top1": (dict(data=8), dict(moe_experts=4), 9, "gpt4"),
    "dp_top2": (dict(data=8), dict(moe_experts=4, moe_top_k=2), 6, "gpt4"),
    "dp_ec": (dict(data=8), dict(moe_experts=4, moe_router="expert_choice"), 6, "gpt4"),
    "ep_top1": (dict(data=4, model=2), dict(moe_experts=4), 9, "gpt4ep"),
}


def _moe_cases(inputs, outdir, out):
    import itertools

    import torch
    import torch.distributed as dist

    from tpu_parallel_torch.core.accumulate import accumulate_gradients
    from tpu_parallel_torch.core.metrics import compute
    from tpu_parallel_torch.core.optim import AdamW
    from tpu_parallel_torch.core.state import TrainState
    from tpu_parallel_torch.models import GPTLM, moe as moe_mod, tiny_test
    from tpu_parallel_torch.models.convert import params_from_jax
    from tpu_parallel_torch.models.generate import generate_sharded
    from tpu_parallel_torch.models.gpt import make_gpt_loss
    from tpu_parallel_torch.models.layers import BlockStack
    from tpu_parallel_torch.parallel import fsdp, pp, tp
    from tpu_parallel_torch.parallel.spmd import build_train_functions, make_model_init
    from tpu_parallel_torch.runtime import MeshConfig, make_mesh
    from tpu_parallel_torch.train_lib import Trainer, TrainerConfig

    meshes = {}

    def mesh_of(sizes):
        key = tuple(sorted(sizes.items()))
        if key not in meshes:
            meshes[key] = make_mesh(MeshConfig(**sizes))
        return meshes[key]

    d4m2 = mesh_of(dict(data=4, model=2))
    out["coords_d4m2"] = np.array([d4m2.get_local_rank("data"), d4m2.get_local_rank("model")])

    # (1) tests/test_moe.py's EP cases: one MoE layer on data=4 x model=2
    # from JAX's one-device params, every rank the same tokens; the dense
    # and all-to-all dispatch's outputs, balance and synced gradients
    x = torch.from_numpy(inputs["moe_x"].copy())
    w_out = torch.from_numpy(inputs["moe_w"].copy())
    full = _moe_state(nested_tree("moe_p", inputs))

    def ep_layer(**over):
        layer = moe_mod.MoEMLP(tiny_test(moe_experts=4, **over), mesh=d4m2)
        _load_full(layer, full)
        return layer

    def synced_grads(layer, prefix):
        params = dict(layer.named_parameters())
        shards = {n: fsdp.shard_info(p) for n, p in params.items() if fsdp.shard_info(p)}
        grads = {n: p.grad for n, p in params.items()}
        fsdp.sync_gradients({n: shards[n].dtensor(g) if n in shards else g
                             for n, g in grads.items()}, ("model",), mesh=d4m2)
        _assembled(out, prefix, grads, shards)

    for kind, over in MOE_EP_KINDS.items():
        layer = ep_layer(**over)
        with torch.no_grad():
            out[f"ep_y_{kind}"] = layer(x)[0].numpy()
        if kind == "top1":
            layer.zero_grad()
            (layer(x)[0] * w_out).sum().backward()
            synced_grads(layer, "ep_g")
    out["ep_expert_shapes"] = np.array(ep_layer().experts.up.kernel.shape)
    for k in (1, 2):
        for dispatch in ("dense", "alltoall"):
            layer = ep_layer(moe_top_k=k, moe_capacity_factor=4.0, moe_dispatch=dispatch)
            before = (moe_mod.ep_alltoall_launches, tp.tp_allgather_launches,
                      tp.tp_allreduce_launches)
            y, bal = layer(x)
            ((y * w_out).sum()).backward()
            out[f"a2a{k}_collectives_{dispatch}"] = np.array([
                moe_mod.ep_alltoall_launches - before[0], tp.tp_allgather_launches - before[1],
                tp.tp_allreduce_launches - before[2]])
            out[f"a2a{k}_y_{dispatch}"] = y.detach().numpy()
            out[f"a2a{k}_bal_{dispatch}"] = np.array(float(bal))
            synced_grads(layer, f"a2a{k}_g_{dispatch}")
    try:
        ep_layer(moe_router="expert_choice", moe_dispatch="alltoall")
        out["a2a_ec_error"] = np.array("")
    except NotImplementedError as exc:
        out["a2a_ec_error"] = np.array(str(exc))
    try:
        ep_layer(moe_dispatch="alltoall")(x[:1, :3])  # 3 tokens over 2 ranks
        out["a2a_tokens_error"] = np.array("")
    except ValueError as exc:
        out["a2a_tokens_error"] = np.array(str(exc))
    try:
        moe_mod.MoEMLP(tiny_test(moe_experts=3), mesh=d4m2)
        out["ep_divide_error"] = np.array("")
    except ValueError as exc:
        out["ep_divide_error"] = np.array(str(exc))

    # (2) tests/test_moe.py's training cases from JAX's init: the step
    # losses and balances, the expert leaves' layout; FSDP on the data mesh
    batch16 = _text_batch(inputs, "b16")
    for case, (sizes, over, steps, init) in MOE_TRAIN_CASES.items():
        for fsdp_on in ((False, True) if case == "dp_top1" else (False,)):
            mesh = mesh_of(sizes)
            fkw = dict(fsdp=True, fsdp_min_size=0) if fsdp_on else {}
            cfg = tiny_test(**over, **fkw)
            model = GPTLM(cfg, device="cpu", mesh=mesh)
            loss_fn = make_gpt_loss(cfg, mesh=mesh)
            funcs = build_train_functions(make_model_init(model, AdamW(lambda count: 3e-3)),
                                          loss_fn, mesh, grad_sync_axes=("data", "model"))
            state = funcs.init_fn(None, params_from_jax(nested_tree(init, inputs), cfg,
                                                        dtype=torch.float32))
            tag = case + ("_fsdp" if fsdp_on else "")
            if case == "ep_top1":
                out["ep_expert_specs"] = np.array(
                    [str(funcs.state_specs[n]) for n in funcs.state_specs if ".experts." in n])
            if fsdp_on:
                info = fsdp.shard_info(model.blocks.layer_0.moe.experts.up.kernel)
                out["fsdp_expert_dim"] = np.array(-1 if info is None else info.dim)
                out["fsdp_expert_local"] = np.array(
                    model.blocks.layer_0.moe.experts.up.kernel.shape)
            n = batch16.size // mesh.size(mesh.mesh_dim_names.index("data"))
            d = mesh.get_local_rank("data")
            local = batch16.rows(d * n, (d + 1) * n)
            losses, bals = [], []
            for _ in range(steps):
                state, m = funcs.step_fn(state, None, local)
                c = compute(m)
                losses.append(c["loss"])
                bals.append(c["moe_balance"])
            out[f"train_{tag}_losses"] = np.array(losses)
            out[f"train_{tag}_bal"] = np.array(bals)

    # (3) tests/test_moe.py:106 on data=2 x seq=2 x model=2: ring attention
    # over seq, experts over model, fsdp=True as JAX's run (each expert
    # stack's model slice split again over data)
    mesh = mesh_of(dict(data=2, seq=2, model=2))
    cfg = tiny_test(moe_experts=2, attn_impl="ring", seq_len=64, fsdp=True, fsdp_min_size=0)
    model = GPTLM(cfg, device="cpu", mesh=mesh)
    funcs = build_train_functions(
        make_model_init(model, AdamW(lambda count: 3e-3)), make_gpt_loss(cfg, mesh=mesh), mesh,
        grad_sync_axes=("data", "seq", "model"), metric_axes=("data", "seq"),
        metric_mean_axes=("model",))
    state = funcs.init_fn(None, params_from_jax(nested_tree("gpt2e64", inputs), cfg,
                                                dtype=torch.float32))
    b = _text_batch(inputs, "b8s64")
    d, c = mesh.get_local_rank("data"), mesh.get_local_rank("seq")
    local = b.rows(4 * d, 4 * d + 4).cols(32 * c, 32 * c + 32)
    losses = []
    for _ in range(9):
        state, m = funcs.step_fn(state, None, local)
        losses.append(compute(m)["loss"])
    out["way4_losses"] = np.array(losses)
    out["way4_count"] = np.array(float(m["loss"][1]))
    out["way4_nested"] = np.array(sum(len(i.axes) == 2 for i in state.shards.values()))

    # (4) tests/test_moe.py's all-to-all Trainer on data=4 x model=2
    trainer = Trainer(TrainerConfig(
        model="tiny", model_overrides=dict(moe_experts=4, moe_top_k=2, moe_dispatch="alltoall",
                                           remat=False, dropout_rate=0.0),
        mesh=dict(data=4, model=2), global_batch_size=8, steps=6, log_every=1000, seed=0),
        mesh=d4m2, device="cpu")
    trainer.init(params_from_jax(nested_tree("a2a_params", inputs), trainer.model_config,
                                 dtype=torch.float32))
    rows = itertools.repeat(trainer.local_rows(_text_batch(inputs, "a2ab")))
    before = moe_mod.ep_alltoall_launches
    first = trainer.train(rows, steps=3)["loss"]
    out["a2a_trainer_alltoalls"] = np.array(moe_mod.ep_alltoall_launches - before)
    out["a2a_trainer_losses"] = np.array([first, trainer.train(rows, steps=3)["loss"]])

    # (5) the pipe cases on data=2 x pipe=4: the router gradient at pipe 4
    # (tests/test_moe.py:263), the per-tick balance table of a one-layer
    # stage (:390), and the lockstep tick against the schedule
    p4 = mesh_of(dict(data=2, pipe=4))
    r = p4.get_local_rank("pipe")
    out["coords_p4"] = np.array([r, p4.get_local_rank("data")])
    cfg4 = tiny_test(moe_experts=2, remat=False, num_microbatches=2, moe_balance_weight=1.0,
                     pipe_size=4)
    params = params_from_jax(nested_tree("gpt2e", inputs), cfg4, dtype=torch.float32,
                             pipe_rank=r)
    st = TrainState.create(GPTLM(cfg4, device="cpu", mesh=p4), AdamW(lambda count: 1e-3),
                           torch.Generator().manual_seed(0), params)
    b8 = _pp_rows(_text_batch(inputs, "b8"), p4)
    grads, _ = accumulate_gradients(st, b8, st.rng, 1, make_gpt_loss(cfg4, train=False,
                                                                      mesh=p4))
    fsdp.sync_gradients(st.partitioned(grads), ("data",), ("pipe",), mesh=p4)
    for leaf in ("moe.router.weight", "attn.qkv.weight"):
        out[f"pp_g/{leaf}"] = grads[f"blocks.layer_{r}.{leaf}"].numpy().copy()

    cfg1 = tiny_test(moe_experts=2, remat=False, num_microbatches=2)
    pm = pp.PipelineModule(lambda: BlockStack(cfg1, 1, device="cpu"), 2, mesh=p4,
                           pass_validity=True)
    pm.stage.layer_0.load_state_dict({k: torch.from_numpy(inputs[f"bubble/{r}/{k}"].copy())
                                      for k in pm.stage.layer_0.state_dict()})
    bx = torch.from_numpy(inputs["bubble_x"].copy())
    with torch.no_grad():
        y, table = pm(bx)
        out["bubble_table"] = table.numpy()
        carry = torch.zeros(2, *bx.shape[1:])
        micro = bx.reshape(2, 2, *bx.shape[1:])
        ticks, collected = [], []
        for t in range(2 + 4 - 1):
            carry, got, bal = pp.execute_pipeline_step(
                pm.stage, carry, micro[min(t, 1)], mesh=p4, tick=t, num_microbatches=2,
                pass_validity=True)
            ticks.append(float(bal))
            collected.append(got)
        out["step_table"] = np.array(ticks)
        if r == 3:
            out["step_out_err"] = np.array(float(
                (torch.cat(collected[3:5]) - y).abs().max()))

    # (6) greedy generate_sharded over data=4 x model=2 (ragged prompts,
    # ample capacity) from JAX's one-device init
    cfg = tiny_test(moe_experts=4, moe_capacity_factor=4.0, remat=False)
    model = GPTLM(cfg, device="cpu", mesh=d4m2)
    _load_full(model, params_from_jax(nested_tree("gpt4", inputs), cfg))
    prompt = torch.from_numpy(inputs["gen_prompt"].copy()).long()
    mask = torch.from_numpy(inputs["gen_mask"].copy())
    out["gen_sharded"] = generate_sharded(model, prompt, d4m2, max_new_tokens=8,
                                          prompt_mask=mask).numpy()
    dist.barrier()


# the Llama family's tiny overrides (tests/test_gpt.py's llama variant)
LLAMA = dict(positional="rope", norm="rmsnorm", mlp="swiglu")
# seq-parallel rope cases: name -> (model overrides, mesh)
LLAMA_SP = {
    "ring_rope": (dict(LLAMA, attn_impl="ring", seq_len=64), dict(data=2, seq=4)),
    "ulysses_rope": (dict(LLAMA, attn_impl="ulysses", seq_len=64), dict(data=2, seq=4)),
}
LLAMA_3D_STEPS = 4
# rope through generate_sharded: name -> (model overrides, mesh)
LLAMA_GEN = {
    "tp": (LLAMA, dict(data=4, model=2)),
    "pp": (dict(LLAMA, pipe_size=2, num_microbatches=2), dict(data=2, model=2, pipe=2)),
}


def _assembled_nested(out, prefix, tree, shards):
    """As :func:`_assembled`, each slice gathered over every axis of its
    (possibly nested) split, innermost first."""
    import torch
    import torch.distributed as dist

    for name, value in tree.items():
        value = value.to_local() if hasattr(value, "to_local") else value
        info = shards.get(name)
        while info is not None:
            parts = [torch.empty_like(value) for _ in range(info.size)]
            dist.all_gather(parts, value.contiguous(), group=info.group)
            value = torch.cat(parts, dim=info.dim)
            info = info.outer
        out[f"{prefix}/{name}"] = value.detach().float().numpy().copy()


def _llama_cases(inputs, outdir, out):
    import torch
    import torch.distributed as dist

    from tpu_parallel_torch.core.accumulate import accumulate_gradients
    from tpu_parallel_torch.core.metrics import compute
    from tpu_parallel_torch.core.optim import AdamW
    from tpu_parallel_torch.models import GPTLM, tiny_test
    from tpu_parallel_torch.models.convert import params_from_jax
    from tpu_parallel_torch.core.state import TrainState
    from tpu_parallel_torch.models.generate import generate_sharded
    from tpu_parallel_torch.models.gpt import make_gpt_loss
    from tpu_parallel_torch.parallel import fsdp, pp
    from tpu_parallel_torch.parallel.spmd import build_train_functions, make_model_init
    from tpu_parallel_torch.parallel.tp import export_single_device_params
    from tpu_parallel_torch.runtime import MeshConfig, make_mesh
    from tpu_parallel_torch.train_lib import Trainer, TrainerConfig

    # (1) ring and Ulysses with rope over data=2 x seq=4: the step's synced
    # gradients and loss from the one-device JAX init
    for name, (overrides, sizes) in LLAMA_SP.items():
        trainer = Trainer(TrainerConfig(model="tiny", model_overrides=overrides, mesh=sizes,
                                        global_batch_size=8, steps=1), device="cpu")
        state = trainer.init(params_from_jax(nested_tree(f"sp_params_{name}", inputs),
                                             trainer.model_config, dtype=torch.float32))
        batch = trainer.local_rows(_text_batch(inputs, f"sp_batch_{name}"))
        grads, metrics = accumulate_gradients(state, batch, state.rng, 1, trainer.loss_fn)
        fsdp.sync_gradients(state.partitioned(grads), ("data", "seq", "model"),
                            mesh=trainer.mesh)
        for key, value in grads.items():
            out[f"sp_{name}_grads/{key}"] = value.numpy().copy()
        loss = torch.tensor([float(metrics["loss"][0]), float(metrics["loss"][1])])
        dist.all_reduce(loss)
        out[f"sp_{name}_loss"] = np.array(float(loss[0] / loss[1]))

    # (2) tests/test_gpt.py:150 with fsdp=True: data=2 x model=2 x pipe=2,
    # from JAX's init; each rank's slices, the step-1 synced gradients,
    # LLAMA_3D_STEPS steps' losses and the final masters
    mesh = make_mesh(MeshConfig(data=2, model=2, pipe=2))
    for axis in ("data", "model", "pipe"):
        out[f"coord_{axis}"] = np.array(mesh.get_local_rank(axis))
    cfg = tiny_test(pipe_size=2, num_microbatches=2, n_layers=4, fsdp=True, fsdp_min_size=0,
                    **LLAMA)
    model = GPTLM(cfg, device="cpu", mesh=mesh)
    loss_fn = make_gpt_loss(cfg, mesh=mesh)
    funcs = build_train_functions(
        make_model_init(model, AdamW(lambda count: 3e-3)), loss_fn, mesh,
        grad_sync_axes=("data", "model"), grad_psum_axes=("pipe",),
        metric_axes=("data", "pipe"), metric_mean_axes=("model",))
    params = params_from_jax(nested_tree("params_3d", inputs), cfg, dtype=torch.float32,
                             pipe_rank=mesh.get_local_rank("pipe"))
    state = funcs.init_fn(None, params)
    for name, value in state.params.items():
        out[f"slices/{name}"] = value.numpy().copy()
        out[f"spec/{name}"] = np.array(str(funcs.state_specs[name]))
    batch = _pp_rows(_text_batch(inputs, "batch_3d"), mesh)
    grads, _ = accumulate_gradients(state, batch, state.rng, 1, loss_fn)
    fsdp.sync_gradients(state.partitioned(grads), ("data", "model"), ("pipe",), mesh=mesh)
    _assembled_nested(out, "grads", grads, state.shards)
    state.zero_grads()
    losses = []
    for _ in range(LLAMA_3D_STEPS):
        state, metrics = funcs.step_fn(state, None, batch)
        losses.append(compute(metrics)["loss"])
    out["losses_3d"] = np.array(losses)
    _assembled_nested(out, "final", state.params, state.shards)
    try:
        export_single_device_params(state.partitioned(state.params))
        out["export_error"] = np.array("")
    except ValueError as exc:
        out["export_error"] = np.array(str(exc))

    # (3) the Trainer over the same mesh: a checkpoint after 2 steps,
    # restored bitwise into a fresh init, one more step on both
    kw = dict(model="tiny", model_overrides=dict(LLAMA, num_microbatches=2, n_layers=4,
                                                 fsdp=True, fsdp_min_size=0),
              mesh=dict(data=2, model=2, pipe=2), global_batch_size=16, steps=2, log_every=1)
    t1 = Trainer(TrainerConfig(**kw), device="cpu")
    t1.init()
    t1.train(steps=2)
    ckpt_dir = os.path.join(outdir, "llama_ckpt")
    t1.save_checkpoint(ckpt_dir, step=t1.state.step)
    t2 = Trainer(TrainerConfig(**kw), device="cpu")
    t2.init()
    restored = t2.restore_checkpoint(ckpt_dir)
    out["ckpt_step"] = np.array(restored.step)
    same = [torch.equal(a, b) for a, b in zip(
        _tensor_leaves(t1.state.state_dict()), _tensor_leaves(restored.state_dict()))]
    out["ckpt_bitwise"] = np.array(all(same) and len(same) > 0)
    nxt = t1.local_rows(t1.example_batch)
    out["ckpt_next_loss"] = np.array([compute(t.step_fn(t.state, None, nxt)[1])["loss"]
                                      for t in (t1, t2)])

    # (4) greedy generate_sharded with rope from JAX's init on 4 ragged
    # prompts: over data=4 x model=2, and through the pipelined decode
    # ring on data=2 x model=2 x pipe=2
    prompt = torch.from_numpy(inputs["gen_prompt"].copy()).long()
    mask = torch.from_numpy(inputs["gen_mask"].copy())
    for name, (overrides, sizes) in LLAMA_GEN.items():
        gmesh = make_mesh(MeshConfig(**sizes))
        gcfg = tiny_test(**dict(overrides, remat=False))
        stage = pp.pipe_axis(gmesh)
        params = params_from_jax(nested_tree(f"gen_params_{name}", inputs), gcfg,
                                 dtype=torch.float32,
                                 pipe_rank=None if stage is None else stage[2])
        gmodel = TrainState.create(GPTLM(gcfg, device="cpu", mesh=gmesh),
                                   AdamW(lambda count: 1e-3), torch.Generator().manual_seed(0),
                                   params).model
        out[f"gen_{name}"] = generate_sharded(gmodel, prompt, max_new_tokens=8,
                                              prompt_mask=mask).numpy()
    dist.barrier()


# encoder MLM cases: name -> (model overrides, mesh, global rows); each
# mirrors a mesh case of tests/test_encoder.py
ENC = dict(bidirectional=True)
POSTNORM = dict(prenorm=False, embed_norm=True, mlp="gelu_exact")
ENCODER_MLM = {
    "dp": (dict(ENC, seq_len=32), dict(data=8), 8),
    "tp": (dict(ENC, seq_len=32), dict(data=4, model=2), 8),
    "pp": (dict(ENC, **POSTNORM, seq_len=32, num_microbatches=2), dict(data=2, model=2, pipe=2), 8),
    "ring": (dict(ENC, attn_impl="ring", seq_len=64), dict(data=2, seq=4), 8),
    "ulysses": (dict(ENC, attn_impl="ulysses", seq_len=64), dict(data=2, seq=4), 8),
    "ring_window": (dict(ENC, attn_impl="ring", attn_window=24, seq_len=64), dict(data=2, seq=4),
                    8),
    "postnorm": (dict(ENC, **POSTNORM, seq_len=32), dict(data=8), 8),
}
ENCODER_STEPS = 5
ENCODER_LR = 3e-3
ENCODER_CLASSES = 4
ENCODER_CLS_STEPS = 25


def _encoder_cases(inputs, outdir, out):
    import torch
    import torch.distributed as dist

    from tpu_parallel_torch.core.accumulate import accumulate_gradients
    from tpu_parallel_torch.core.losses import make_classification_loss
    from tpu_parallel_torch.core.metrics import compute
    from tpu_parallel_torch.core.optim import AdamW
    from tpu_parallel_torch.core.state import Batch, TextBatch
    from tpu_parallel_torch.models import layers
    from tpu_parallel_torch.models.convert import params_from_jax
    from tpu_parallel_torch.models.gpt import EncoderClassifier, mlm_mask, tiny_test
    from tpu_parallel_torch.ops.ring_attention import ring_attention, ring_flash_attention
    from tpu_parallel_torch.ops.ulysses import ulysses_attention
    from tpu_parallel_torch.parallel import fsdp
    from tpu_parallel_torch.parallel.spmd import build_train_functions, make_model_init
    from tpu_parallel_torch.runtime import MeshConfig, make_mesh
    from tpu_parallel_torch.runtime.mesh import axis_group
    from tpu_parallel_torch.train_lib import Trainer, TrainerConfig

    # (1) the MLM step over each mesh: the synced gradients on the test's
    # mask (JAX's draw), then ENCODER_STEPS steps on the port's own masks
    for name, (overrides, sizes, rows) in ENCODER_MLM.items():
        trainer = Trainer(TrainerConfig(
            model="tiny", objective="mlm", model_overrides=overrides, mesh=sizes,
            global_batch_size=rows, steps=ENCODER_STEPS, learning_rate=ENCODER_LR,
            warmup_steps=1, lr_schedule="constant"), device="cpu")
        out[f"{name}_coord"] = np.array([axis_group(trainer.mesh, a)[2]
                                         if axis_group(trainer.mesh, a) else 0
                                         for a in ("data", "model", "pipe", "seq")])
        state = trainer.init(params_from_jax(nested_tree(f"{name}_params", inputs),
                                             trainer.model_config, dtype=torch.float32))
        batch = trainer.local_rows(_text_batch(inputs, f"{name}_batch"))
        mask = torch.from_numpy(inputs[f"{name}_mask"].copy()).long()
        masked = trainer.local_rows(TextBatch(tokens=mask, targets=mask)).tokens.bool()
        grads, _ = accumulate_gradients(
            state, batch, state.rng, 1,
            lambda model, b, rng: trainer.loss_fn(model, b, rng, masked=masked))
        fsdp.sync_gradients(state.partitioned(grads), ("data", "seq", "model"), ("pipe",),
                            mesh=trainer.mesh)
        _assembled_nested(out, f"{name}_grads", grads, state.shards)
        state.zero_grads()
        losses = []
        for _ in range(ENCODER_STEPS):
            state, metrics = trainer.step_fn(state, None, batch)
            losses.append(compute(metrics)["loss"])
        out[f"{name}_losses"] = np.array(losses)
        out[f"{name}_params"] = np.array(sorted(state.params))

    # (2) the MLM corruption pattern over data 2 x model 2 x seq 2
    mesh = make_mesh(MeshConfig(data=2, model=2, seq=2))
    out["mask_coord"] = np.array([mesh.get_local_rank(a) for a in ("data", "model", "seq")])
    out["mask"] = mlm_mask(tiny_test(), torch.zeros(4, 16, dtype=torch.long),
                           torch.Generator().manual_seed(5), 0.3, mesh).numpy()

    # (3) EncoderClassifier over data=8: the synced step-1 gradients, then
    # ENCODER_CLS_STEPS steps of the classification loss
    mesh = make_mesh(MeshConfig(data=8))
    cfg = tiny_test(bidirectional=True, seq_len=16, scan_layers=False)
    model = EncoderClassifier(cfg, ENCODER_CLASSES, device="cpu", seed=None, mesh=mesh)
    loss_fn = make_classification_loss("data", mesh)
    funcs = build_train_functions(make_model_init(model, AdamW(lambda count: 1e-2)), loss_fn,
                                  mesh)
    state = funcs.init_fn(None, params_from_jax(nested_tree("cls_params", inputs), cfg,
                                                dtype=torch.float32))
    rank = mesh.get_local_rank("data")
    per = inputs["cls_tokens"].shape[0] // 8
    local = Batch(inputs=torch.from_numpy(inputs["cls_tokens"][rank * per:(rank + 1) * per]).long(),
                  labels=torch.from_numpy(inputs["cls_labels"][rank * per:(rank + 1) * per]).long())
    grads, _ = accumulate_gradients(state, local, state.rng, 1, loss_fn)
    fsdp.sync_gradients(state.partitioned(grads), ("data",), mesh=mesh)
    _assembled_nested(out, "cls_grads", grads, state.shards)
    state.zero_grads()
    history = []
    for _ in range(ENCODER_CLS_STEPS + 1):
        state, metrics = funcs.step_fn(state, None, local)
        history.append([compute(metrics)["loss"], compute(metrics)["accuracy"]])
    out["cls_history"] = np.array(history)

    # (4) the bidirectional ring (plain and flash-composed) and Ulysses with
    # the bidirectional flash inner attention over data 2 x seq 4, each on
    # this rank's block
    mesh = make_mesh(MeshConfig(data=2, seq=4))
    q, k, v = (torch.from_numpy(inputs[f"op_{n}"].copy()) for n in "qkv")
    seg = torch.from_numpy(inputs["op_seg"].copy()).int()
    s = q.shape[1] // 4
    j = mesh.get_local_rank("seq")
    block = lambda x: x[:, j * s:(j + 1) * s]  # noqa: E731
    for impl, fn in (("ring_plain", ring_attention), ("ring_flash", ring_flash_attention)):
        out[f"op_{impl}"] = fn(block(q), block(k), block(v), axis_name="seq", mesh=mesh,
                               segment_ids=block(seg), causal=False).numpy()
    window = int(inputs["op_window"])
    inner = functools.partial(layers.bidirectional_flash_attention, block_q=32, block_k=32,
                              window=window)
    out["op_ulysses_window"] = ulysses_attention(block(q), block(k), block(v), axis_name="seq",
                                                 mesh=mesh, attn_fn=inner).numpy()
    out["op_seq"] = np.array(j)
    dist.barrier()


# seq2seq training cases: name -> (model overrides, mesh, global rows); each
# mirrors a mesh case of tests/test_seq2seq.py
S2S_TRAIN = {
    "dp": (dict(), dict(data=8), 16),
    "tp": (dict(), dict(data=4, model=2), 16),
    # the T5 bias under TP: each rank slices its heads off the full bias
    "tp_relative": (dict(positional="relative", norm="rmsnorm"), dict(data=4, model=2), 16),
    "fsdp": (dict(fsdp=True, fsdp_min_size=0), dict(data=8), 16),
    "moe": (dict(moe_experts=4, moe_top_k=1), dict(data=4, model=2), 16),
    "ring": (dict(attn_impl="ring", seq_len=64, src_seq_len=64), dict(data=2, seq=4), 8),
    "ulysses": (dict(attn_impl="ulysses", seq_len=64, src_seq_len=64), dict(data=2, seq=4), 8),
    "pp": (dict(enc_layers=4, n_layers=4, num_microbatches=4), dict(data=2, pipe=4), 16),
}
S2S_STEPS = 4
S2S_LR = 3e-3
S2S_GEN = dict(rows=8, new=5, bos=1)


def _s2s_batch(inputs, prefix):
    import torch

    from tpu_parallel_torch.models.seq2seq import Seq2SeqBatch

    def get(name):
        return torch.from_numpy(inputs[f"{prefix}/{name}"].copy())

    return Seq2SeqBatch(src_tokens=get("src_tokens").long(), tokens=get("tokens").long(),
                        targets=get("targets").long(), src_mask=get("src_mask").bool())


def _error(fn):
    """``str`` of the NotImplementedError or ValueError ``fn`` raises ("" if
    none)."""
    try:
        fn()
    except (NotImplementedError, ValueError) as exc:
        return np.array(str(exc))
    return np.array("")


def _seq2seq_cases(inputs, outdir, out):
    import torch
    import torch.distributed as dist

    from tpu_parallel_torch.core.accumulate import accumulate_gradients
    from tpu_parallel_torch.core.losses import token_cross_entropy
    from tpu_parallel_torch.core.metrics import compute
    from tpu_parallel_torch.core.optim import AdamW
    from tpu_parallel_torch.core.state import TrainState
    from tpu_parallel_torch.models import GPTLM, tiny_test
    from tpu_parallel_torch.models.convert import params_from_jax
    from tpu_parallel_torch.models.generate import generate, generate_sharded
    from tpu_parallel_torch.models.gpt import _lm_head_params, make_ce_fn
    from tpu_parallel_torch.models.seq2seq import (EncoderDecoder, make_seq2seq_loss,
                                                   seq2seq_generate, seq2seq_generate_sharded,
                                                   tiny_seq2seq)
    from tpu_parallel_torch.parallel import fsdp
    from tpu_parallel_torch.parallel.tp import export_single_device_params
    from tpu_parallel_torch.runtime import MeshConfig, make_mesh
    from tpu_parallel_torch.runtime.mesh import axis_group
    from tpu_parallel_torch.train_lib import Trainer, TrainerConfig

    src = torch.from_numpy(inputs["gen_src"].copy()).long()
    # (1) the Trainer over each mesh from JAX's weights: the step-1 synced
    # gradients (assembled over the model and data splits), then S2S_STEPS
    # steps' losses; the generation and CE legs of tests/test_seq2seq.py on
    # the trained states
    for name, (overrides, sizes, rows) in S2S_TRAIN.items():
        trainer = Trainer(TrainerConfig(
            model="tiny_seq2seq", model_overrides=overrides, mesh=sizes, global_batch_size=rows,
            steps=S2S_STEPS, learning_rate=S2S_LR, warmup_steps=1, lr_schedule="constant",
            objective="seq2seq"), device="cpu")
        mesh, cfg = trainer.mesh, trainer.model_config
        state = trainer.init(params_from_jax(nested_tree(f"{name}_params", inputs), cfg,
                                             dtype=torch.float32))
        batch = trainer.local_rows(_s2s_batch(inputs, f"{name}_batch"))
        grads, _ = accumulate_gradients(state, batch, state.rng, 1, trainer.loss_fn)
        fsdp.sync_gradients(state.partitioned(grads), ("data", "seq", "model"), ("pipe",),
                            mesh=mesh)
        _assembled_nested(out, f"{name}_grads", grads, state.shards)
        state.zero_grads()
        losses = []
        for _ in range(S2S_STEPS):
            state, metrics = trainer.step_fn(state, None, batch)
            losses.append(compute(metrics)["loss"])
        out[f"{name}_losses"] = np.array(losses)
        out[f"{name}_specs"] = np.array(sorted(f"{n}={trainer.funcs.state_specs[n]}"
                                               for n in state.params))
        model = trainer.model.eval()
        if name == "dp":
            # tests/test_seq2seq.py:252: sharded decoding == plain decoding
            # on the exported one-device weights
            full = export_single_device_params(state.partitioned(state.params))
            plain = EncoderDecoder(tiny_seq2seq(), device="cpu", seed=None)
            plain.load_state_dict({k: v.to(torch.float32) for k, v in full.items()})
            out["exported_plain"] = seq2seq_generate(
                plain.eval(), src, max_new_tokens=S2S_GEN["new"], bos_id=S2S_GEN["bos"]).numpy()
            out["exported_sharded"] = seq2seq_generate_sharded(
                model, src, max_new_tokens=S2S_GEN["new"], bos_id=S2S_GEN["bos"]).numpy()
            for key, value in full.items():
                out[f"exported/{key}"] = value.float().numpy().copy()
        if name == "tp":
            # :195: the vocab-parallel CE equals the full CE of the gathered
            # logits; :275: TP greedy decoding equals the teacher-forced
            # argmax of the same state's forward under the mesh
            with torch.no_grad():
                hidden = model(batch.src_tokens, batch.tokens, src_mask=batch.src_mask,
                               hidden_only=True)
                mask = torch.ones(batch.targets.shape)
                vp, _ = make_ce_fn(cfg, mesh)(_lm_head_params(cfg, model), hidden,
                                              batch.targets, mask)
                logits = model(batch.src_tokens, batch.tokens, src_mask=batch.src_mask)
                full_ce = (token_cross_entropy(logits, batch.targets) * mask).sum()
            out["tp_ce"] = np.array([float(vp), float(full_ce)])
            toks = seq2seq_generate_sharded(model, src[:4], max_new_tokens=S2S_GEN["new"],
                                            bos_id=S2S_GEN["bos"])
            forced = torch.cat([torch.full((4, 1), S2S_GEN["bos"]), toks[:, :-1]], dim=1)
            with torch.no_grad():
                ref = model(src[:4], forced).float().argmax(-1)
            out["tp_gen"], out["tp_gen_forced"] = toks.numpy(), ref.numpy()
            _assembled_nested(out, "tp_final", state.params, state.shards)
        if name == "moe":
            out["moe_balance"] = np.array(compute(metrics)["moe_balance"])
        if name == "pp":
            out["pp_coord"] = np.array(mesh.get_local_rank("pipe"))
        if name in ("ring", "ulysses"):
            # :360: the SP model's global-mean eval loss over the seq-sharded
            # batch equals the dense (xla) model's on the whole rows, one
            # set of weights
            weights = params_from_jax(nested_tree(f"{name}_params", inputs), cfg,
                                      dtype=torch.float32)
            TrainState.create(model, AdamW(lambda count: 0.0), torch.Generator(), weights)
            with torch.no_grad():
                _, m = make_seq2seq_loss(cfg, train=False, mesh=mesh)(model, batch)
                total = torch.stack([m["loss"][0], m["loss"][1]])
                dist.all_reduce(total, group=axis_group(mesh, "data")[0])
                dist.all_reduce(total, group=axis_group(mesh, "seq")[0])
                dense_cfg = tiny_seq2seq(**dict(overrides, attn_impl="xla"))
                dense = EncoderDecoder(dense_cfg, device="cpu", seed=None)
                dense.load_state_dict(weights)
                _, dm = make_seq2seq_loss(dense_cfg, train=False)(
                    dense, _s2s_batch(inputs, f"{name}_batch"))
            out[f"{name}_sp_vs_dense"] = np.array([float(total[0] / total[1]),
                                                   float(dm["loss"][0] / dm["loss"][1])])

    # (2) tests/test_train_lib.py:168: the seq2seq Trainer over data 4 x
    # model 2 on its own batches: train and evaluate below the first loss
    trainer = Trainer(TrainerConfig(model="tiny_seq2seq", mesh=dict(data=4, model=2),
                                    global_batch_size=16, steps=6, log_every=100,
                                    objective="seq2seq"), device="cpu")
    trainer.init()
    first = trainer.evaluate(steps=1)["loss"]
    m = trainer.train()
    ev = trainer.evaluate(steps=2)
    out["trainer_family"] = np.array([first, m["loss"], ev["loss"],
                                      float("tokens_per_sec" in m)])

    # (3) the mesh-bound refusals (:528, :579): the relative bias under a
    # pipeline, decoding on a pipe mesh and under sequence parallelism
    mesh = make_mesh(MeshConfig(data=2, pipe=4))
    out["refuse_rel_pp"] = _error(lambda: EncoderDecoder(tiny_seq2seq(
        pipe_size=4, enc_layers=4, n_layers=4, positional="relative", norm="rmsnorm"),
        device="cpu", mesh=mesh))
    model_pp = EncoderDecoder(tiny_seq2seq(pipe_size=4, enc_layers=4, n_layers=4),
                              device="cpu", mesh=mesh)
    z = torch.zeros(4, 8, dtype=torch.long)
    out["refuse_pp_decode"] = _error(lambda: model_pp(z, z, decode=True))
    mesh = make_mesh(MeshConfig(data=2, seq=4))
    model_sp = EncoderDecoder(tiny_seq2seq(attn_impl="ring", seq_len=64, src_seq_len=64),
                              device="cpu", mesh=mesh)
    z = torch.zeros(4, 16, dtype=torch.long)
    out["refuse_sp_decode"] = _error(lambda: model_sp(z, z, decode=True))

    # (4) tests/test_generate.py:711: a relative-bias GPTLM decodes on the
    # sharded path without a mask, over data=8, as one process does
    mesh = make_mesh(MeshConfig(data=8))
    rcfg = tiny_test(positional="relative", norm="rmsnorm", dense_bias=False)
    weights = params_from_jax(nested_tree("rel_params", inputs), rcfg, dtype=torch.float32)
    rmodel = TrainState.create(GPTLM(rcfg, device="cpu", seed=None, mesh=mesh),
                               AdamW(lambda count: 0.0), torch.Generator(), weights).model
    prompt = torch.from_numpy(inputs["rel_prompt"].copy()).long()
    out["rel_sharded"] = generate_sharded(rmodel, prompt, max_new_tokens=4).numpy()
    single = GPTLM(rcfg, device="cpu", seed=None)
    single.load_state_dict(weights)
    out["rel_single"] = generate(single, prompt, max_new_tokens=4).numpy()
    dist.barrier()


SUITES = {"runtime": _runtime_cases, "dp": _dp_cases, "fsdp": _fsdp_cases, "tp": _tp_cases,
          "pp": _pp_cases, "sp": _sp_cases,
          "moe": _moe_cases, "llama": _llama_cases, "encoder": _encoder_cases,
          "seq2seq": _seq2seq_cases}


def run_suite(suite, outdir):
    """One rank's run of ``suite`` (called in every rank of the group)."""
    import torch.distributed as dist

    inputs = dict(np.load(os.path.join(outdir, "inputs.npz")))
    out = {}
    SUITES[suite](inputs, outdir, out)
    np.savez(os.path.join(outdir, f"{suite}_rank{dist.get_rank()}.npz"), **out)


def main(suite, outdir, num_ranks):
    from tpu_parallel_torch.runtime import spawn_cpu_ranks

    spawn_cpu_ranks(num_ranks, run_suite, suite, outdir)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    main(sys.argv[1], sys.argv[2], int(sys.argv[3]))
