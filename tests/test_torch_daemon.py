"""The port's durable daemon (``tpu_parallel_torch/daemon``) held to the
JAX package's.  Both daemons run the same journal-driven scenario over
engines on the same bridged ``tiny_test`` fp32 weights and a fake clock,
and must leave the same record: every request's status, tokens and
finish reason, the journal record for record (CRCs included), and the
``daemon_*`` / ``cluster_*`` counters.  The journals are also held to
each other ACROSS the packages: each daemon recovers from a journal the
other wrote mid-stream and finishes bitwise equal to JAX's never-crashed
run.  Then the port alone: the HTTP/SSE face in process (a cancel that
cannot race completion, drain, a clean journal) and the three gates of
``python -m tpu_parallel_torch.daemon.serve`` as real subprocesses.

Each JAX reference is computed once per module; the JAX side imports
inside fixtures only."""

import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from tpu_parallel_torch.daemon import (
    EXIT_CLEAN,
    REC_SHUTDOWN,
    DaemonConfig,
    DaemonHTTPServer,
    ServingDaemon,
    WallClock,
    load_state,
    read_journal,
)
from tpu_parallel_torch.models import GPTLM, tiny_test
from tpu_parallel_torch.models.convert import params_from_jax

torch.set_num_threads(1)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LENS = [3, 5, 4, 7]
NEW = 8


class FakeClock:
    """Callable clock + sleep: the daemon's whole fake-time surface."""

    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def sleep(self, seconds: float) -> None:
        self.t += seconds


@dataclasses.dataclass
class Env:
    prompts: list
    jmodel: object
    jparams: object
    sd: dict
    refs: list  # JAX static generate(), greedy


@pytest.fixture(scope="module")
def env():
    import jax
    import jax.numpy as jnp

    from tpu_parallel.models import GPTLM as JGPT
    from tpu_parallel.models import tiny_test as jtiny
    from tpu_parallel.models.generate import generate as jgenerate

    jmodel = JGPT(jtiny(dtype=jnp.float32, remat=False))
    rng = np.random.default_rng(11)
    prompts = [[int(t) for t in rng.integers(1, 256, n)] for n in LENS]
    params = jmodel.init({"params": jax.random.PRNGKey(1)}, jnp.ones((1, 7), jnp.int32),
                         train=False)["params"]
    refs = [[int(t) for t in np.asarray(jgenerate(
        jmodel, params, jnp.asarray(p, jnp.int32)[None, :], max_new_tokens=NEW))[0]]
        for p in prompts]
    sd = params_from_jax(jax.tree.map(np.asarray, params), tiny_test())
    return Env(prompts, jmodel, params, sd, refs)


class Side:
    def __init__(self, kind, env):
        self.kind, self.env = kind, env
        if kind == "jax":
            import tpu_parallel.cluster as cluster
            import tpu_parallel.daemon as daemon
            import tpu_parallel.serving as serving
            from tpu_parallel.obs.registry import MetricRegistry
        else:
            import tpu_parallel_torch.cluster as cluster
            import tpu_parallel_torch.daemon as daemon
            import tpu_parallel_torch.serving as serving
            from tpu_parallel_torch.obs.registry import MetricRegistry
        self.cluster, self.daemon, self.serving = cluster, daemon, serving
        self.MetricRegistry = MetricRegistry
        self.Request = serving.Request

    def factory(self):
        def frontend_factory(clock):
            kw = dict(n_slots=2, scheduler=self.serving.SchedulerConfig(max_prefills_per_tick=2),
                      decode_steps_per_tick=1)
            if self.kind == "jax":
                engine = self.serving.ServingEngine(self.env.jmodel, self.env.jparams, **kw)
            else:
                model = GPTLM(tiny_test(), device="cpu", seed=None)
                model.load_state_dict(self.env.sd)
                engine = self.serving.ServingEngine(model, **kw)
            return self.cluster.Frontend(
                [engine], router="least", config=self.cluster.FrontendConfig(restart=None),
                clock=clock, registry=self.MetricRegistry())
        return frontend_factory

    def daemon_at(self, path, clock=None, **cfg):
        cfg.setdefault("fsync_batch", 4)
        return self.daemon.ServingDaemon(self.factory(), str(path), clock=clock or FakeClock(),
                                         config=self.daemon.DaemonConfig(**cfg))


def _series(d):
    snap = d.registry.snapshot()
    return sorted((row["name"], tuple(sorted(row["labels"].items())), row["value"])
                  for row in snap["counters"] + snap["gauges"]
                  if row["name"].startswith(("daemon_", "cluster_")))


def _results(d, rids):
    out = []
    for rid in rids:
        rec = d.result(rid)
        out.append((rec["status"], rec["finish_reason"], rec["tokens"], rec.get("recovered")))
    return out


def _tick_until_done(d, rids, max_ticks=80):
    for _ in range(max_ticks):
        if all(d.result(r)["status"] == "finished" for r in rids):
            return
        d.tick()


def _life1(s, path, n=3, ticks=5):
    """Accept ``n`` requests, tick a few times, then the kill -9: no
    shutdown record, no final sync."""
    d = s.daemon_at(path)
    for i in range(n):
        d.submit(s.Request(prompt=s.env.prompts[i], max_new_tokens=NEW, request_id=f"r{i}"),
                 dedupe_token=f"tok-{i}")
    for _ in range(ticks):
        d.tick()
    partial = [len(d.result(f"r{i}")["tokens"]) for i in range(n)]
    d.journal.abort()
    return partial


def dc_crash_recovery(s, tmp):
    path = os.path.join(tmp, f"{s.kind}_crash.jsonl")
    partial = _life1(s, path)
    d2 = s.daemon_at(path)
    dup = d2.submit(s.Request(prompt=s.env.prompts[0], max_new_tokens=NEW), dedupe_token="tok-0")
    rids = ["r0", "r1", "r2"]
    _tick_until_done(d2, rids)
    d2.request_drain()
    rc = d2.run(max_ticks=50)
    records, torn = read_journal(path)
    return dict(partial=partial, dup=(dup["request_id"], dup.get("recovered")),
                results=_results(d2, rids), rc=rc, torn=torn, journal=records,
                series=_series(d2), reserved=d2.frontend._reserved)


def dc_drain(s, tmp):
    path = os.path.join(tmp, f"{s.kind}_drain.jsonl")
    d = s.daemon_at(path)
    d.submit(s.Request(prompt=s.env.prompts[0], max_new_tokens=NEW, request_id="r0"))
    d.tick()
    d.request_drain()
    rc = d.run(max_ticks=100)
    late = d.submit(s.Request(prompt=s.env.prompts[1], max_new_tokens=4, request_id="late"))
    records, torn = read_journal(path)
    return dict(rc=rc, results=_results(d, ["r0"]),
                late=(late["status"], late["finish_reason"]), journal=records, torn=torn,
                series=_series(d))


def dc_forced_then_recover(s, tmp):
    path = os.path.join(tmp, f"{s.kind}_forced.jsonl")
    d = s.daemon_at(path)
    d.submit(s.Request(prompt=s.env.prompts[0], max_new_tokens=NEW, request_id="r0"),
             dedupe_token="t0")
    d.tick()
    d.request_drain()
    d.request_drain()  # the second TERM: fast shutdown
    rc = d.run(max_ticks=100)
    d2 = s.daemon_at(path)
    _tick_until_done(d2, ["r0"])
    records, _ = read_journal(path)
    return dict(rc=rc, results=_results(d2, ["r0"]), journal=records, series=_series(d2))


DAEMON_SCENARIOS = {
    "crash_recovery": dc_crash_recovery,
    "drain": dc_drain,
    "forced_then_recover": dc_forced_then_recover,
}


@pytest.fixture(scope="module")
def jax_record(env, tmp_path_factory):
    cache = {}

    def get(name):
        if name not in cache:
            tmp = str(tmp_path_factory.mktemp(f"jax_{name}"))
            cache[name] = DAEMON_SCENARIOS[name](Side("jax", env), tmp)
        return cache[name]

    return get


@pytest.mark.parametrize("name", sorted(DAEMON_SCENARIOS))
def test_daemon_scenario_matches_jax(env, jax_record, tmp_path, name):
    """The port's daemon against JAX's: results, journal (record for
    record, CRCs included) and counters equal."""
    got = DAEMON_SCENARIOS[name](Side("torch", env), str(tmp_path))
    want = jax_record(name)
    assert set(got) == set(want)
    for key in want:
        assert got[key] == want[key], f"{name}.{key}"


def test_daemon_scenarios_prove_their_point(env, jax_record):
    rec = jax_record("crash_recovery")
    assert any(0 < n < NEW for n in rec["partial"])  # the kill landed mid-stream
    assert rec["dup"] == ("r0", True)
    assert [r[:3] for r in rec["results"]] == [("finished", "length", env.refs[i])
                                                for i in range(3)]
    assert rec["rc"] == EXIT_CLEAN and rec["reserved"] == 0
    assert rec["journal"][-1]["record"] == REC_SHUTDOWN and rec["journal"][-1]["clean"]
    drain = jax_record("drain")
    assert drain["late"] == ("rejected", "draining")
    forced = jax_record("forced_then_recover")
    assert forced["rc"] == 1 and forced["results"][0][2] == env.refs[0]


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_journal_recovers_across_packages(env, jax_record, tmp_path, writer, reader):
    """A journal one package's daemon wrote mid-stream (then killed) is
    recovered by the other's, which finishes every request bitwise equal
    to JAX's never-crashed run."""
    path = str(tmp_path / "cross.jsonl")
    _life1(Side(writer, env), path)
    d2 = Side(reader, env).daemon_at(path)
    rids = ["r0", "r1", "r2"]
    _tick_until_done(d2, rids)
    assert load_state(path).recoveries == 1
    assert [d2.result(r)["tokens"] for r in rids] == env.refs[:3]
    assert [d2.result(r)["status"] for r in rids] == ["finished"] * 3
    # the never-crashed run of the same scenario
    clean = jax_record("crash_recovery")
    assert [r[2] for r in clean["results"]] == env.refs[:3]


def _call(port, method, path, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method=method)
    if data is not None:
        req.add_header("Content-Type", "application/json")
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read()


def test_http_endpoints_sse_cancel_and_drain(env, tmp_path):
    """The stdlib HTTP face over the port's daemon on a wall clock:
    submit, SSE to the end, /healthz, /statez, /metricsz, a cancel that
    cannot race completion (the request is queued before the pump
    starts), drain to exit 0 and a journal whose last word is clean."""
    s = Side("torch", env)
    path = str(tmp_path / "j.jsonl")
    d = ServingDaemon(s.factory(), path, clock=WallClock(),
                      config=DaemonConfig(fsync_batch=4, grace_seconds=30.0))
    server = DaemonHTTPServer(d).start()
    port = server.port
    try:
        code, body = _call(port, "GET", "/healthz")
        assert code == 200 and json.loads(body)["ok"]
        code, body = _call(port, "POST", "/v1/submit", {
            "prompt": env.prompts[1], "max_new_tokens": NEW, "dedupe_token": "doomed"})
        assert code == 200
        doomed = json.loads(body)["request_id"]
        code, _ = _call(port, "POST", f"/v1/cancel/{doomed}")  # no pump yet: still queued
        assert code == 200
        code, body = _call(port, "POST", "/v1/cancel/nope")
        assert code == 404
        code, body = _call(port, "POST", "/v1/submit", {
            "prompt": env.prompts[0], "max_new_tokens": NEW, "dedupe_token": "http-0"})
        assert code == 200
        rid = json.loads(body)["request_id"]
        code, _ = _call(port, "POST", "/v1/submit", {"prompt": "nope"})
        assert code == 400
        rc_box = []
        pump = threading.Thread(target=lambda: rc_box.append(d.run()), daemon=True)
        pump.start()
        code, payload = _call(port, "GET", f"/v1/stream/{rid}")
        events = [json.loads(line[len(b"data: "):]) for line in payload.split(b"\n")
                  if line.startswith(b"data: ")]
        assert [e["token"] for e in events if "token" in e] == env.refs[0]
        assert events[-1]["finished"] and events[-1]["finish_reason"] == "length"
        code, body = _call(port, "GET", f"/v1/result/{doomed}")
        rec = json.loads(body)
        assert rec["status"] == "cancelled" and rec["tokens"] == []
        code, body = _call(port, "GET", "/statez")
        state = json.loads(body)
        assert code == 200 and state["cluster"]["inflight_tokens"] == 0
        assert state["daemon"]["degraded_reason"] is None
        code, body = _call(port, "GET", "/metricsz")
        assert code == 200 and b"daemon_journal_records_total" in body
        assert b"cluster_submitted_total" in body
        d.request_drain()
        pump.join(timeout=60)
        assert rc_box == [EXIT_CLEAN]
        code, _ = _call(port, "GET", "/healthz")
        assert code == 503
    finally:
        server.stop()
    records, torn = read_journal(path)
    assert torn == 0 and records[-1]["record"] == REC_SHUTDOWN and records[-1]["clean"]


def test_handler_calls_run_on_the_pump_stream(env, tmp_path):
    """On the CPU the daemon records no CUDA stream, so handler-thread
    engine calls run unchanged; the pump re-reads its streams in run()."""
    s = Side("torch", env)
    d = ServingDaemon(s.factory(), str(tmp_path / "j.jsonl"), clock=FakeClock(),
                      config=DaemonConfig(fsync_batch=4))
    assert d._streams == {}
    with d._on_pump_stream():
        assert d.cancel("nope") is False


@pytest.mark.parametrize("gate", ["--smoke", "--disk-smoke", "--kv-disk-smoke"])
def test_serve_gate_subprocess(gate):
    """``python -m tpu_parallel_torch.daemon.serve <gate> --device cpu``
    as a real process whose children receive real signals (start, HTTP,
    SSE, kill -9, journal rot, disk-tier warm restart)."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO_ROOT, env.get("PYTHONPATH")) if p)
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_parallel_torch.daemon.serve", gate, "--device", "cpu"],
        cwd=REPO_ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "serve: OK" in proc.stdout


def test_serve_child_refuses_without_gpu(tmp_path):
    """The child defaults to the card: without one it fails, unless it is
    given ``--device cpu``."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    from tpu_parallel_torch.daemon import serve

    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        serve.main(["--serve", "--journal", str(tmp_path / "j.jsonl"),
                    "--ready-file", str(tmp_path / "r.json")])
    assert not os.path.exists(tmp_path / "r.json")


def test_sighup_reload_rolls_a_weight_set_and_journals_it(env, tmp_path):
    """SIGHUP's reload reads ``reload_path``, rolls the named weight set
    through ``Frontend.begin_swap`` and journals a typed decision; a spec
    without a checkpoint_dir is a typed no-op."""
    from tpu_parallel_torch.checkpoint import save_serving_weights
    from tpu_parallel_torch.daemon import REC_DECISION
    from tpu_parallel_torch.models.convert import params_to_jax

    s = Side("torch", env)
    weights = tmp_path / "weights"
    spec = tmp_path / "reload.json"
    spec.write_text(json.dumps({"note": "no dir"}))
    d = s.daemon_at(tmp_path / "j.jsonl", reload_path=str(spec))
    d.request_reload()
    d.run(max_ticks=1)
    moved = {k: v * 0.5 for k, v in env.sd.items()}
    save_serving_weights(str(weights), 7, params_to_jax(moved, tiny_test()))
    spec.write_text(json.dumps({"checkpoint_dir": str(weights)}))
    d.request_reload()
    d.run(max_ticks=1)
    assert d.frontend.swap_status()["to_version"] == "step-7"
    for _ in range(200):
        if d.frontend.swap_status()["state"] != "rolling":
            break
        d.clock.sleep(0.1)  # the canary's clean window is on the daemon's clock
        d.tick()
    assert d.frontend.swap_status()["state"] == "completed"
    engine = d.frontend.replicas[0].engine
    assert all(torch.equal(t, moved[k]) for k, t in engine.params.items())
    decisions = [r["verdict"] for r in read_journal(str(tmp_path / "j.jsonl"))[0]
                 if r["record"] == REC_DECISION and r.get("kind") == "reload"]
    assert decisions == ["no_checkpoint_dir", "rolling"]


def test_concurrent_submit_and_cancel_while_pumping(env, tmp_path):
    """Handler-style threads (more than cores) submit and cancel while the
    pump ticks, with a short switch interval: every accepted request ends
    in exactly one terminal, in the results and in the journal, and no
    token reservation leaks."""
    from tpu_parallel_torch.daemon import REC_TERMINAL

    s = Side("torch", env)
    path = str(tmp_path / "j.jsonl")
    d = ServingDaemon(s.factory(), path, clock=WallClock(),
                      config=DaemonConfig(fsync_batch=4, idle_sleep_seconds=0.0005))
    accepted, errors = [], []
    rc = []
    pump = threading.Thread(target=lambda: rc.append(d.run()), daemon=True)

    def client(k):
        try:
            for j in range(4):
                rec = d.submit(s.Request(prompt=env.prompts[(k + j) % len(env.prompts)],
                                         max_new_tokens=6), dedupe_token=f"c{k}-{j}")
                accepted.append(rec["request_id"])
                if (k + j) % 3 == 0:
                    d.cancel(rec["request_id"])
        except Exception as exc:  # noqa: BLE001 — reported by the assertion below
            errors.append(repr(exc))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        pump.start()
        clients = [threading.Thread(target=client, args=(k,)) for k in range(2 * (os.cpu_count() or 4))]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=60)
        assert not any(c.is_alive() for c in clients) and not errors, errors
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and any(
                d.result(r)["status"] not in ("finished", "cancelled") for r in accepted):
            time.sleep(0.01)
        d.request_drain()
        pump.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not pump.is_alive() and rc == [EXIT_CLEAN]
    statuses = [d.result(r)["status"] for r in accepted]
    assert set(statuses) <= {"finished", "cancelled"} and "finished" in statuses
    assert d.frontend._reserved == 0
    terminals = {}
    for r in read_journal(path)[0]:
        if r["record"] == REC_TERMINAL:
            terminals[r["request_id"]] = terminals.get(r["request_id"], 0) + 1
    assert sorted(terminals) == sorted(accepted) and set(terminals.values()) == {1}


def test_submit_waits_at_most_one_tick_while_pumping(env, tmp_path):
    """The pump hands the daemon lock to blocked handler threads between
    ticks: a submit made while a long request decodes returns within a
    tick or two, not after the busy stretch (a plain ``RLock`` lets the
    pump take the lock back first)."""
    s = Side("torch", env)
    d = ServingDaemon(s.factory(), str(tmp_path / "j.jsonl"), clock=WallClock(),
                      config=DaemonConfig(fsync_batch=4))
    d.submit(s.Request(prompt=env.prompts[0], max_new_tokens=28, request_id="long"))
    rc = []
    pump = threading.Thread(target=lambda: rc.append(d.run()), daemon=True)
    pump.start()
    try:
        deadline = time.monotonic() + 30
        while d.ticks < 3 and time.monotonic() < deadline:
            time.sleep(0.001)
        waited = []
        for i in range(5):
            before = d.ticks
            d.submit(s.Request(prompt=env.prompts[1], max_new_tokens=2, request_id=f"s{i}"))
            waited.append(d.ticks - before)
        assert d.result("long")["status"] != "finished", "the long request ended too soon"
        assert max(waited) <= 2, waited
    finally:
        d.request_drain()
        pump.join(timeout=60)
    assert rc == [EXIT_CLEAN]
