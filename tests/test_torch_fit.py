"""Port parity: ``Trainer.fit`` and ``evaluate``, the configs and the CLI.

The counterparts of ``tests/test_fault_tolerance.py``'s five GPT cases
(checkpoint and resume, rollback after a step failure injected through the
``step_fn`` seam, exact data replay, giving up after ``max_failures``,
keeping the best checkpoint) and ``tests/test_eval.py``'s three (metrics,
determinism under dropout, no change to the state), plus a fit of 6 steps
resumed to 10 that is bitwise equal to an uninterrupted 10-step fit.  The
port's three configs against the JAX ``get_config().to_dict()``, one step
of each with the model swapped for ``tiny`` (as ``tests/test_configs.py``
does), the refusal of the configs the port cannot run, CLI overrides typed
as ``ml_collections`` types them, and ``python -m tpu_parallel_torch.train``
end to end on the CPU.  JAX and ``ml_collections`` are imported inside the
tests that use them.
"""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tpu_parallel_torch.configs import CONFIGS, UNPORTED, get_config, override
from tpu_parallel_torch.data import DataLoader, TokenDataset
from tpu_parallel_torch.train_lib import Trainer, TrainerConfig

# one torch intra-op thread per test process (pytest-xdist shares the cores)
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
PLUMBING = ("checkpoint_dir", "checkpoint_every", "data_path", "data_format", "eos_id",
            "eval_steps", "eval_every", "keep_best", "eval_fraction")


def _config(steps, **kw):
    base = dict(model="tiny", model_overrides=dict(num_microbatches=1), global_batch_size=8,
                steps=steps, log_every=100, donate=False, seed=3)
    base.update(kw)
    return TrainerConfig(**base)


def _loader(trainer, seed=1, holdout=0.0):
    tokens = np.random.default_rng(0).integers(0, 256, size=20_000, dtype=np.uint16)
    ds = TokenDataset(tokens, seq_len=trainer.model_config.seq_len)
    return DataLoader(ds, trainer.config.global_batch_size, seed=seed,
                      holdout_fraction=holdout, device="cpu")


def test_fit_checkpoints_and_resumes(tmp_path):
    run = str(tmp_path / "run")
    t1 = Trainer(_config(6), device="cpu")
    t1.fit(run, checkpoint_every=3)
    assert t1.state.step == 6
    # a fresh process-equivalent: new Trainer, same dir -> resumes at 6 and
    # runs only the remaining 4 steps
    t2 = Trainer(_config(10), device="cpu")
    seen = []
    t2.fit(run, checkpoint_every=3, log_fn=lambda s, m: seen.append(s))
    assert t2.state.step == 10 and seen == [10]
    fresh = Trainer(_config(10), device="cpu")
    fresh.init()
    assert not torch.equal(t2.state.params["lm_head.weight"], fresh.state.params["lm_head.weight"])


def test_fit_recovers_from_step_failure(tmp_path):
    """A step failure rolls back to the last checkpoint and retries."""
    t = Trainer(_config(8), device="cpu")
    real_step = t.step_fn
    boom = {"at": 6, "done": False}

    def flaky_step(state, metrics, batch):
        if state.step == boom["at"] and not boom["done"]:
            boom["done"] = True
            raise RuntimeError("injected device failure")
        return real_step(state, metrics, batch)

    t.step_fn = flaky_step
    t.fit(str(tmp_path / "run"), checkpoint_every=2)
    assert boom["done"], "failure was never injected"
    assert t.state.step == 8


def test_fit_data_loader_replays_exact_order(tmp_path):
    """With a step-indexed loader, a retried step re-consumes its batch,
    and a failure after part of a step's work leaves no trace: the run
    equals one that never failed."""
    def run(fail_at):
        t = Trainer(_config(6), device="cpu")
        dl = _loader(t)
        fed = []
        real_batch_at = dl.batch_at
        dl.batch_at = lambda step: fed.append(step) or real_batch_at(step)
        real_step = t.step_fn
        boom = {"done": False}

        def flaky_step(state, metrics, batch):
            if state.step == fail_at and not boom["done"]:
                boom["done"] = True
                # half a step: gradients summed, masters moved, then the fault
                real_step(state, metrics, batch)
                raise RuntimeError("injected failure")
            return real_step(state, metrics, batch)

        t.step_fn = flaky_step
        t.fit(str(tmp_path / f"run{fail_at}"), data_loader=dl, checkpoint_every=2)
        return t, fed

    t, fed = run(fail_at=4)
    assert fed.count(4) == 2, fed
    assert t.state.step == 6
    clean, _ = run(fail_at=-1)
    for name, p in clean.state.params.items():
        assert torch.equal(t.state.params[name], p), name


def test_fit_gives_up_after_max_failures(tmp_path):
    run = str(tmp_path / "run")
    t = Trainer(_config(4), device="cpu")
    t.fit(run, checkpoint_every=1, steps=2)

    def always_fails(state, metrics, batch):
        raise RuntimeError("permanent failure")

    t.step_fn = always_fails
    with pytest.raises(RuntimeError, match="permanent failure"):
        t.fit(run, checkpoint_every=1, steps=4, max_failures=2)
    # nothing saved yet: the first failure re-raises
    t2 = Trainer(_config(4), device="cpu")
    t2.step_fn = always_fails
    with pytest.raises(RuntimeError, match="permanent failure"):
        t2.fit(str(tmp_path / "empty"), checkpoint_every=1)


def test_fit_keeps_best_checkpoint(tmp_path):
    """keep_best snapshots the lowest-eval-loss state under best/ with
    best_loss.json, and the snapshot restores."""
    from tpu_parallel_torch.checkpoint import Checkpointer

    t = Trainer(_config(6, global_batch_size=16, learning_rate=1e-2, log_every=10), device="cpu")
    stream = np.arange(50_000, dtype=np.uint16) % t.model_config.vocab_size
    loader = DataLoader(TokenDataset(stream, t.model_config.seq_len), 16, holdout_fraction=0.2,
                        device="cpu")
    seen = []
    with pytest.raises(ValueError, match="eval_view"):
        t.fit(str(tmp_path / "x"), eval_every=2)
    with pytest.raises(ValueError, match="keep_best"):
        t.fit(str(tmp_path / "x"), data_loader=loader, keep_best=True)
    t.fit(str(tmp_path / "run"), data_loader=loader, checkpoint_every=3, eval_every=2,
          eval_steps=1, keep_best=True, log_fn=lambda s, m: seen.append((s, m)))
    evals = [(s, m) for s, m in seen if "eval_loss" in m]
    assert [s for s, _ in evals] == [2, 4, 6]
    best = Checkpointer(str(tmp_path / "run" / "best"))
    record = json.loads((tmp_path / "run" / "best" / "best_loss.json").read_text())
    assert best.latest_step == record["step"]
    assert record["loss"] == min(m["eval_loss"] for _, m in evals)
    restored = Trainer(_config(6, global_batch_size=16), device="cpu")
    restored.init()
    best.restore(restored.state)
    assert restored.state.step == best.latest_step
    best.close()


def test_fit_resumed_midway_is_bitwise_uninterrupted(tmp_path):
    """6 steps, then a new Trainer resuming to 10, equals 10 steps in one
    run, bitwise: masters, moments, EMA shadow, generator (dropout draws
    from it) and step."""
    kw = dict(ema_decay=0.9, num_minibatches=2,
              model_overrides=dict(num_microbatches=1, dropout_rate=0.1))
    first = Trainer(_config(10, **kw), device="cpu")
    first.fit(str(tmp_path / "resumed"), data_loader=_loader(first), checkpoint_every=3,
              steps=6)
    assert first.state.step == 6
    resumed = Trainer(_config(10, **kw), device="cpu")
    resumed.fit(str(tmp_path / "resumed"), data_loader=_loader(resumed), checkpoint_every=3)
    whole = Trainer(_config(10, **kw), device="cpu")
    whole.fit(str(tmp_path / "whole"), data_loader=_loader(whole), checkpoint_every=3)
    a, b = resumed.state.state_dict(), whole.state.state_dict()
    assert a["step"] == b["step"] == 10 and torch.equal(a["rng"], b["rng"])
    for field in ("params", "ema_params"):
        for name, value in b[field].items():
            assert torch.equal(a[field][name], value), (field, name)
    for name, value in b["opt_state"][1]["mu"].items():
        assert torch.equal(a["opt_state"][1]["mu"][name], value)
        assert torch.equal(a["opt_state"][1]["nu"][name], b["opt_state"][1]["nu"][name])


def _eval_trainer(**overrides):
    return Trainer(_config(4, global_batch_size=16,
                           model_overrides=dict(num_microbatches=1, **overrides)), device="cpu")


def test_evaluate_returns_metrics():
    t = _eval_trainer()
    t.init()
    ev = t.evaluate(steps=3)
    assert set(ev) >= {"loss", "accuracy"} and ev["loss"] > 0


def test_evaluate_is_deterministic_with_dropout_model():
    """Eval runs with dropout off: repeated evals on one batch agree
    exactly, where two training losses do not."""
    t = _eval_trainer(dropout_rate=0.3)
    t.init()
    assert t.evaluate(steps=1) == t.evaluate(steps=1)
    a, _ = t.loss_fn(t.model, t.example_batch, t.state.rng)
    b, _ = t.loss_fn(t.model, t.example_batch, t.state.rng)
    assert a.item() != b.item()


def test_evaluate_does_not_change_state():
    t = _eval_trainer()
    t.config.ema_decay = 0.5  # evaluate swaps the shadow in and back out
    t.init()
    t.step_fn(t.state, None, t.example_batch)
    before = {n: p.detach().clone() for n, p in t.model.named_parameters()}
    masters = {n: p.clone() for n, p in t.state.params.items()}
    t.evaluate(steps=2)
    assert all(torch.equal(p, before[n]) for n, p in t.model.named_parameters())
    assert all(torch.equal(p, masters[n]) for n, p in t.state.params.items())


def _jax_config(name):
    path = REPO / "configs" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"jax_cfg_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.get_config().to_dict()


@pytest.mark.parametrize("name", CONFIGS)
def test_config_matches_jax_and_runs_one_step(name):
    """Every shared key equals the JAX config's value (the JAX-only
    ``simulate_cpu_devices`` aside, where the port does not run it), and one
    step runs in this process with the model swapped for ``tiny`` (seq_len
    clamped to 128, a chunked loss kept at 64)."""
    ours, theirs = get_config(name), _jax_config(name)
    # the port declares simulate_cpu_devices where its CLI runs the ranks
    jax_only = set() if "simulate_cpu_devices" in ours else {"simulate_cpu_devices"}
    assert set(theirs) - set(ours) == jax_only and set(ours) <= set(theirs)
    for key, value in ours.items():
        assert value == theirs[key], key
    d = {k: v for k, v in ours.items() if k not in PLUMBING + ("simulate_cpu_devices",)}
    if ours.get("simulate_cpu_devices"):
        d["mesh"] = dict(data=-1)  # one process here; tests/test_torch_dp.py runs its ranks
    overrides = dict(d.pop("model_overrides"))
    if d["mesh"].get("pipe", 1) > 1:
        # one process here, one stage: tests/test_torch_pp.py runs the pipe
        d["mesh"] = dict(data=-1)
        overrides["pipe_interleave"] = 1
    if d["mesh"].get("model", 1) > 1:
        # one process here, every expert on it: tests/test_torch_moe.py runs
        # the model axis
        d["mesh"] = dict(data=-1)
    if overrides.get("seq_len") and overrides["seq_len"] > 128:
        overrides["seq_len"] = 128
        if overrides.get("loss_chunk"):
            overrides["loss_chunk"] = 64
    d.update(model="tiny", steps=1, log_every=1, global_batch_size=2 * d["num_minibatches"],
             model_overrides=overrides)
    trainer = Trainer(TrainerConfig.from_config_dict(d), device="cpu")
    out = trainer.train()
    assert np.isfinite(out["loss"]) and trainer.state.step == 1


def test_unported_configs_raise():
    for name in UNPORTED:
        assert os.path.exists(REPO / "configs" / f"{name}.py"), name
        with pytest.raises(NotImplementedError, match="item [56]"):
            get_config(f"configs/{name}.py")
    shipped = {p.stem for p in (REPO / "configs").glob("*.py")} - {"common", "__init__"}
    assert shipped == set(CONFIGS) | set(UNPORTED)
    with pytest.raises(KeyError):
        get_config("gpt2_999m")


def test_cli_overrides_type_as_ml_collections():
    from absl import flags
    from ml_collections import config_flags

    from tpu_parallel_torch.train import parse_args

    overrides = ["--config.steps=4", "--config.model_overrides.loss_chunk=1024",
                 "--config.model_overrides.n_layers=2", "--config.learning_rate=1e-3",
                 "--config.keep_best=false", "--config.model_overrides.attn_impl=xla",
                 "--config.ema_decay=1", "--config.model_overrides.remat=0",
                 "--config.model_overrides.bidirectional=true", "--config.mesh.data=1",
                 "--config.data_path=/x/y.bin"]
    argv = ["prog", "--config=configs/gpt2_125m_corpus.py", *overrides]
    fv = flags.FlagValues()
    config_flags.DEFINE_config_file("config", None, "config", flag_values=fv, sys_argv=argv)
    fv(argv)
    want = fv.config.to_dict()
    got, args = parse_args(["--config=gpt2_125m_corpus", *overrides, "--device=cpu"])
    assert args.device == "cpu"
    for key, value in got.items():
        if isinstance(value, dict):
            for sub, v in value.items():
                assert v == want[key][sub] and type(v) is type(want[key][sub]), (key, sub)
        else:
            assert value == want[key] and type(value) is type(want[key]), key
    with pytest.raises(KeyError):
        override(get_config("gpt2_125m_dp"), "model_overrides.no_such_knob", "1")
    with pytest.raises(KeyError):
        override(get_config("gpt2_125m_dp"), "eval_fraction", "0.1")  # not declared here
    with pytest.raises(ValueError):
        override(get_config("gpt2_125m_dp"), "steps", "1.5")


def test_cli_trains_end_to_end(tmp_path):
    """``python -m tpu_parallel_torch.train`` on packed data with a
    checkpoint directory: exits 0, writes a trace with ``data_wait`` and
    ``compute`` spans and metrics with ``train_loss``, and a second run
    resumes from the checkpoint."""
    rng = np.random.default_rng(0)
    docs = [np.append(rng.integers(1, 200, int(rng.integers(3, 40))), 255) for _ in range(800)]
    data = tmp_path / "corpus.bin"
    TokenDataset.write_bin(str(data), np.concatenate(docs))
    trace, metrics = tmp_path / "trace.json", tmp_path / "metrics.prom"
    cmd = [sys.executable, "-m", "tpu_parallel_torch.train", "--config=gpt2_125m_corpus",
           "--config.model=tiny", "--config.global_batch_size=8", "--config.eos_id=255",
           "--config.model_overrides.attn_impl=xla", f"--config.data_path={data}",
           "--config.data_format=packed", f"--config.checkpoint_dir={tmp_path / 'ckpt'}",
           "--config.eval_steps=2", f"--trace-out={trace}", f"--metrics-out={metrics}",
           "--device=cpu"]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    for steps in (2, 3):
        out = subprocess.run(cmd + [f"--config.steps={steps}"], cwd=REPO, env=env,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr[-3000:]
    events = json.loads(trace.read_text())["traceEvents"]
    assert {"data_wait", "compute"} <= {e["name"] for e in events}
    # the second run resumed at step 2: it ran (and traced) step 3 alone
    assert [e["args"]["step"] for e in events if e["name"] == "compute"] == [3]
    assert "step 3: " in out.stdout
    assert "train_loss" in metrics.read_text()
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["2", "3", "best"]
