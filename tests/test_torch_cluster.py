"""The port's serving cluster (``tpu_parallel_torch/cluster``) held to the
JAX package's: both frontends drive engines on the same bridged
``tiny_test`` fp32 weights through the same scenario on the same fake
clock, and every scenario's record must be EQUAL across the packages:
each request's greedy tokens, status and finish reason, retries, the
replicas' health transitions tick by tick, the ``cluster_*`` counters and
gauges, and the frontend summary.  Scenarios: healthy serving, a
mid-flight crash under the per-step, fused and unified ticks, the
watchdog's stall kill, restart through probation, priority aging,
deadlines, drain, a rolling swap that promotes, a spot-check rollback
(whose stash must not alias the live weights), and an autopilot
scale-up.  Plus the router, replica and migration units on the port
alone.

Each JAX reference is computed once per module (``jax_record``); the
JAX side imports inside fixtures only."""

import dataclasses

import numpy as np
import pytest
import torch

from tpu_parallel_torch.cluster import (
    DEAD,
    HEALTHY,
    PROBATION,
    FaultPlan,
    PrefixAffinityRouter,
    ReplicaHandle,
    RoundRobinRouter,
    make_router,
    prefix_route_key,
)
from tpu_parallel_torch.cluster.migration import land_exports
from tpu_parallel_torch.models import GPTLM, tiny_test
from tpu_parallel_torch.models.convert import params_from_jax
from tpu_parallel_torch.serving.kv_hierarchy import MIGRATE_NOT_PAGED
from tpu_parallel_torch.serving import (
    Request,
    SchedulerConfig,
    ServingEngine,
    validate_same_shapes,
)

torch.set_num_threads(1)

NEW = 8
LENS = [3, 9, 6, 12, 5, 7, 4, 8]


@dataclasses.dataclass
class Env:
    prompts: list
    jmodel: object
    jparams: dict  # name -> JAX params tree
    sd: dict  # name -> the port's state dict of the same weights


@pytest.fixture(scope="module")
def env():
    import jax
    import jax.numpy as jnp

    from tpu_parallel.models import GPTLM as JGPT
    from tpu_parallel.models import tiny_test as jtiny

    jmodel = JGPT(jtiny(dtype=jnp.float32, remat=False))
    rng = np.random.default_rng(7)
    prompts = [[int(t) for t in rng.integers(1, 256, n)] for n in LENS]
    probe = jnp.ones((1, max(LENS)), jnp.int32)
    jparams, sd = {}, {}
    for name, seed in (("v1", 1), ("v2", 2), ("corrupt", 99)):
        p = jmodel.init({"params": jax.random.PRNGKey(seed)}, probe, train=False)["params"]
        jparams[name] = p
        sd[name] = params_from_jax(jax.tree.map(np.asarray, p), tiny_test())
    return Env(prompts, jmodel, jparams, sd)


class Side:
    """One package's cluster API, engines and weights behind the same
    names, so a scenario runs unchanged on either side."""

    def __init__(self, kind, env):
        self.kind, self.env = kind, env
        if kind == "jax":
            import tpu_parallel.cluster as cluster
            import tpu_parallel.serving as serving
            from tpu_parallel.obs.registry import MetricRegistry
        else:
            import tpu_parallel_torch.cluster as cluster
            import tpu_parallel_torch.serving as serving
            from tpu_parallel_torch.obs.registry import MetricRegistry
        self.cluster, self.serving, self.MetricRegistry = cluster, serving, MetricRegistry
        for name in ("Frontend", "FrontendConfig", "ReplicaHandle", "FaultPlan",
                     "RestartPolicy", "SwapPolicy", "AutopilotPolicy"):
            setattr(self, name, getattr(cluster, name))
        self.Request = serving.Request

    def engine(self, clock=None, weights="v1", **kw):
        kwargs = dict(n_slots=2, scheduler=self.serving.SchedulerConfig(max_prefills_per_tick=2),
                      decode_steps_per_tick=1)
        if clock is not None:
            kwargs["clock"] = clock
        kwargs.update(kw)
        if self.kind == "jax":
            return self.serving.ServingEngine(self.env.jmodel, self.env.jparams[weights], **kwargs)
        model = GPTLM(tiny_test(), device="cpu", seed=None)  # each engine owns its model
        model.load_state_dict(self.env.sd[weights])
        return self.serving.ServingEngine(model, **kwargs)

    def weights(self, name):
        return self.env.jparams[name] if self.kind == "jax" else self.env.sd[name]

    def serve_weights(self, engine, name):
        """Make ``engine`` serve other weights behind the swap's back (a
        corrupted load)."""
        if self.kind == "jax":
            engine.params = self.env.jparams[name]
        else:
            with torch.no_grad():
                for key, t in engine.params.items():
                    t.copy_(self.env.sd[name][key])

    def serves(self, engine, name) -> bool:
        if self.kind == "jax":
            import jax

            return all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(
                jax.tree.leaves(engine.params), jax.tree.leaves(self.env.jparams[name])))
        return all(torch.equal(t, self.env.sd[name][k]) for k, t in engine.params.items())


class Trail:
    """Replica health per tick, consecutive repeats collapsed."""

    def __init__(self):
        self.rows = []

    def note(self, fe):
        row = tuple((h.replica_id, h.health) for h in fe.replicas)
        if not self.rows or self.rows[-1] != row:
            self.rows.append(row)


def _record(fe, outs, trail, **extra):
    snap = fe.registry.snapshot()
    series = sorted(
        (row["name"], tuple(sorted(row["labels"].items())), row["value"])
        for row in snap["counters"] + snap["gauges"]
        if row["name"].startswith("cluster_")
    )
    return dict(
        tokens=[[int(t) for t in o.tokens] for o in outs],
        status=[(o.status, o.finish_reason) for o in outs],
        retries=[o.retries for o in outs],
        health=trail.rows,
        series=series,
        summary=fe.summary(),
        **extra,
    )


def _run(fe, trail, t=None, dt=0.05, max_ticks=400, submit=None, until=None):
    """Tick until idle with no swap in flight (or ``until``), noting the
    health trail; ``submit(tick)`` may inject arrivals."""
    for tick in range(max_ticks):
        if submit is not None:
            submit(tick)
        if until is not None:
            if until():
                return tick
        elif (not fe.has_work()
              and fe.swap_status()["state"] not in ("rolling", "rolling_back")
              and getattr(submit, "done", True)):
            return tick
        if t is not None:
            t[0] += dt
        fe.step()
        trail.note(fe)
    return max_ticks


# -- scenarios ---------------------------------------------------------------


def sc_healthy(s):
    t = [0.0]
    clock = lambda: t[0]  # noqa: E731
    fe = s.Frontend([s.engine(clock), s.engine(clock)], router="least", clock=clock)
    trail = Trail()
    outs = [fe.submit(s.Request(prompt=p, max_new_tokens=NEW)) for p in s.env.prompts]
    _run(fe, trail, t)
    return _record(fe, outs, trail)


def _crash(s, engine_kw, crash_at, new, router="rr"):
    t = [0.0]
    clock = lambda: t[0]  # noqa: E731
    h0 = s.ReplicaHandle(0, s.engine(clock, **engine_kw), fault_plan=s.FaultPlan(crash_at_tick=crash_at))
    h1 = s.ReplicaHandle(1, s.engine(clock, **engine_kw))
    fe = s.Frontend([h0, h1], router=router, clock=clock)
    trail = Trail()
    outs = [fe.submit(s.Request(prompt=p, max_new_tokens=new)) for p in s.env.prompts]
    _run(fe, trail, t)
    return _record(fe, outs, trail)


def sc_crash_per_step(s):
    return _crash(s, dict(prefill_buckets=None), 3, NEW)


def sc_crash_fused(s):
    return _crash(s, dict(prefill_buckets=(4, 8, 16), decode_steps_per_tick=4), 2, 16)


def sc_crash_unified(s):
    return _crash(s, dict(prefill_buckets=(4, 8, 16), prefill_chunk_tokens=4,
                          decode_steps_per_tick=4), 2, 12)


def sc_watchdog_kill(s):
    t = [0.0]
    clock = lambda: t[0]  # noqa: E731
    h0 = s.ReplicaHandle(0, s.engine(clock), fault_plan=s.FaultPlan(stall_at_tick=2, stall_ticks=10 ** 9))
    h1 = s.ReplicaHandle(1, s.engine(clock))
    fe = s.Frontend([h0, h1], router="rr", clock=clock,
                    config=s.FrontendConfig(watchdog_ticks=2, watchdog_kill_ticks=4))
    trail = Trail()
    outs = [fe.submit(s.Request(prompt=p, max_new_tokens=NEW)) for p in s.env.prompts]
    _run(fe, trail, t)
    return _record(fe, outs, trail)


def sc_restart_probation(s):
    t = [0.0]
    clock = lambda: t[0]  # noqa: E731
    mk = lambda: s.engine(clock)  # noqa: E731
    h0 = s.ReplicaHandle(0, mk(), fault_plan=s.FaultPlan(crash_at_tick=2), engine_factory=mk)
    h1 = s.ReplicaHandle(1, mk())
    policy = s.RestartPolicy(max_restarts=2, backoff_seconds=1.0, probation_ticks=3,
                             probation_requests=1)
    fe = s.Frontend([h0, h1], router="rr", clock=clock, config=s.FrontendConfig(restart=policy))
    trail = Trail()
    outs = [fe.submit(s.Request(prompt=p, max_new_tokens=NEW)) for p in s.env.prompts]
    _run(fe, trail, t, dt=0.25)
    outs += [fe.submit(s.Request(prompt=p, max_new_tokens=4)) for p in s.env.prompts[:4]]
    _run(fe, trail, t, dt=0.25)
    return _record(fe, outs, trail, restarts=h0.restarts,
                   served_after_restart=h0.engine.metrics.finished)


def sc_priority_aging(s):
    t = [0.0]
    clock = lambda: t[0]  # noqa: E731
    fe = s.Frontend([s.engine(clock, n_slots=1)], clock=clock,
                    config=s.FrontendConfig(aging_seconds=2.0))
    trail = Trail()
    p = s.env.prompts
    low = fe.submit(s.Request(prompt=p[0], max_new_tokens=2, priority=0))
    outs, finished_at = [low], None
    for k in range(40):
        t[0] += 1.0
        outs += [fe.submit(s.Request(prompt=p[2], max_new_tokens=2, priority=5)) for _ in range(2)]
        fe.step()
        trail.note(fe)
        if finished_at is None and low.status == "finished":
            finished_at = k
    return _record(fe, outs, trail, low_finished_at=finished_at)


def sc_deadlines(s):
    p = s.env.prompts
    t = [0.0]
    clock = lambda: t[0]  # noqa: E731
    fe = s.Frontend([s.engine(clock)], clock=clock)
    trail = Trail()
    seen = []
    a = fe.submit(s.Request(prompt=p[0], max_new_tokens=20, deadline=5.0,
                            on_token=lambda ev: seen.append((ev.token, ev.finish_reason))))
    b = fe.submit(s.Request(prompt=p[1], max_new_tokens=NEW))
    t[0] = 1.0
    fe.step()
    t[0] = 6.0
    fe.step()
    _run(fe, trail)
    # a pending (never-dispatched) request past its deadline cancels too
    t2 = [0.0]
    clock2 = lambda: t2[0]  # noqa: E731
    fe2 = s.Frontend([s.engine(clock2, n_slots=1)], clock=clock2)
    busy = fe2.submit(s.Request(prompt=p[0], max_new_tokens=NEW))
    lazy = fe2.submit(s.Request(prompt=p[1], max_new_tokens=NEW, deadline=2.0))
    t2[0] = 1.0
    fe2.step()
    t2[0] = 3.0
    fe2.step()
    trail2 = Trail()
    _run(fe2, trail2)
    return dict(first=_record(fe, [a, b], trail, stream=seen),
                second=_record(fe2, [busy, lazy], trail2))


def sc_drain(s):
    clock = lambda: 0.0  # noqa: E731 — drain() ticks internally, time stands still
    engines = [s.engine(clock, n_slots=1) for _ in range(2)]
    fe = s.Frontend(engines, router="least", clock=clock,
                    config=s.FrontendConfig(dispatch_queue_depth=4))
    trail = Trail()
    outs = [fe.submit(s.Request(prompt=p, max_new_tokens=6)) for p in s.env.prompts]
    fe.step()
    queued = [e.scheduler.depth for e in engines]
    events = fe.drain(max_ticks=300)
    late = fe.submit(s.Request(prompt=s.env.prompts[0], max_new_tokens=2))
    return _record(fe, outs + [late], trail, queued=queued,
                   finished_events=sum(ev.finished for ev in events),
                   free=[e.pool.n_free for e in engines],
                   draining=[e.draining for e in engines])


def _swap_cluster(s, n, clock):
    def mk():
        return s.engine(clock)

    handles = [s.ReplicaHandle(i, mk(), engine_factory=mk) for i in range(n)]
    config = s.FrontendConfig(
        retry_limit=16, watchdog_ticks=5, watchdog_kill_ticks=20,
        restart=s.RestartPolicy(backoff_seconds=0.1, probation_ticks=2, probation_requests=2),
    )
    return s.Frontend(handles, router="least", clock=clock, config=config)


def sc_swap_promote(s):
    t = [0.0]
    fe = _swap_cluster(s, 2, lambda: t[0])
    trail = Trail()
    p = s.env.prompts
    outs = [fe.submit(s.Request(prompt=q, max_new_tokens=NEW)) for q in p[:4]]
    for _ in range(3):
        t[0] += 0.05
        fe.step()
        trail.note(fe)
    st = fe.begin_swap(params=s.weights("v2"), version="v2", policy=s.SwapPolicy(
        drain_ticks=40, canary_ticks=2, canary_seconds=0.1, canary_requests=1))
    later = []

    def submit(tick):
        if tick % 4 == 0 and len(later) < 4:
            later.append(fe.submit(s.Request(prompt=p[4 + len(later)], max_new_tokens=NEW)))
        submit.done = len(later) >= 4

    submit.done = False
    _run(fe, trail, t, max_ticks=800, submit=submit)
    status = fe.swap_status()
    return _record(fe, outs + later, trail, begin=st["state"], swap=status,
                   serves_v2=[s.serves(h.engine, "v2") for h in fe.replicas])


def sc_swap_rollback(s):
    """The spot check catches a canary serving weights other than the
    shipped ones; the rollback restores the stashed pre-swap weights."""
    t = [0.0]
    fe = _swap_cluster(s, 1, lambda: t[0])
    trail = Trail()
    fe.begin_swap(params=s.weights("v2"), version="v2", policy=s.SwapPolicy(
        drain_ticks=2, canary_ticks=1, canary_seconds=0.05, canary_requests=1, spot_check=True))
    _run(fe, trail, t, until=lambda: fe.swap_status().get("canary") == 0
         or fe.swap_status()["state"] != "rolling")
    canary = fe.swap_status()["canary"]
    s.serve_weights(fe._handle(0).engine, "corrupt")
    out = fe.submit(s.Request(prompt=s.env.prompts[0], max_new_tokens=4))
    _run(fe, trail, t, max_ticks=800)
    after = fe.submit(s.Request(prompt=s.env.prompts[1], max_new_tokens=NEW))
    _run(fe, trail, t)
    return _record(fe, [out, after], trail, canary=canary, swap=fe.swap_status(),
                   serves_v1=s.serves(fe._handle(0).engine, "v1"))


def sc_autopilot_scale_up(s):
    t = [0.0]
    clock = lambda: t[0]  # noqa: E731

    def factory():
        return s.engine(clock, n_slots=1)

    fe = s.Frontend(
        [s.ReplicaHandle(0, factory(), engine_factory=factory)], router="least", clock=clock,
        config=s.FrontendConfig(watchdog_ticks=4, watchdog_kill_ticks=16, restart=s.RestartPolicy(
            backoff_seconds=0.1, probation_ticks=2, probation_requests=2)))
    fe.enable_autopilot(s.AutopilotPolicy(
        queue_age_target=0.3, window_ticks=4, breach_ticks=2, clear_ticks=4,
        max_shed_fraction=0.0, max_replicas=2, scale_cooldown_ticks=2))
    trail = Trail()
    p = s.env.prompts
    outs = [fe.submit(s.Request(prompt=list(p[i % len(p)]), max_new_tokens=6)) for i in range(8)]
    for _ in range(2):
        t[0] += 0.4
        fe.step()
        trail.note(fe)
    _run(fe, trail, t, max_ticks=800)
    actions = [dataclasses.asdict(a) for a in fe._autopilot.actions]
    return _record(fe, outs, trail, actions=actions, replicas=len(fe.replicas),
                   fresh_served=fe.replicas[-1].engine.metrics.finished)


SCENARIOS = {
    "healthy": sc_healthy,
    "crash_per_step": sc_crash_per_step,
    "crash_fused": sc_crash_fused,
    "crash_unified": sc_crash_unified,
    "watchdog_kill": sc_watchdog_kill,
    "restart_probation": sc_restart_probation,
    "priority_aging": sc_priority_aging,
    "deadlines": sc_deadlines,
    "drain": sc_drain,
    "swap_promote": sc_swap_promote,
    "swap_rollback": sc_swap_rollback,
    "autopilot_scale_up": sc_autopilot_scale_up,
}


@pytest.fixture(scope="module")
def jax_record(env):
    """Each scenario's JAX record, computed once per module."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = SCENARIOS[name](Side("jax", env))
        return cache[name]

    return get


def _assert_equal(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), f"{path}: keys {sorted(set(got) ^ set(want))}"
        for k in want:
            _assert_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), f"{path}: {len(got)} != {len(want)} items"
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_equal(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert got == pytest.approx(want, rel=1e-9, abs=1e-9), f"{path}: {got} != {want}"
    else:
        assert got == want, f"{path}: {got!r} != {want!r}"


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_jax(env, jax_record, name):
    """The port's frontend, swap and autopilot against JAX's on one
    scenario: every field of the record equal."""
    got = SCENARIOS[name](Side("torch", env))
    _assert_equal(got, jax_record(name), name)


def test_scenarios_prove_their_point(env, jax_record):
    """The scenarios exercise what they are named for (on the JAX
    record, which the port's equals)."""
    rec = {name: jax_record(name) for name in SCENARIOS}
    for name in ("crash_per_step", "crash_fused", "crash_unified"):
        r = rec[name]
        assert r["summary"]["replica_deaths"] == 1 and r["summary"]["retries"] > 0, name
        assert all(st == ("finished", "length") for st in r["status"]), name
    assert rec["watchdog_kill"]["summary"]["watchdog_kills"] == 1
    r = rec["restart_probation"]
    assert r["restarts"] == 1 and r["served_after_restart"] > 0
    assert any(dict(row)[0] == PROBATION for row in r["health"])
    assert dict(r["health"][-1][0:1])[0] == HEALTHY
    assert rec["priority_aging"]["low_finished_at"] is not None
    d = rec["deadlines"]
    assert d["first"]["status"][0] == ("cancelled", "deadline")
    assert d["second"]["status"][1] == ("cancelled", "deadline")
    assert rec["drain"]["status"][-1] == ("rejected", "draining")
    assert rec["swap_promote"]["swap"]["state"] == "completed"
    assert all(rec["swap_promote"]["serves_v2"])
    rb = rec["swap_rollback"]
    assert rb["swap"]["state"] == "rolled_back" and rb["serves_v1"]
    assert rec["autopilot_scale_up"]["replicas"] == 2
    assert rec["autopilot_scale_up"]["fresh_served"] >= 1


def test_crash_replay_equals_healthy_tokens(env, jax_record):
    """Failover changes nothing about greedy output: the per-step crash
    scenario's tokens equal the healthy run's."""
    assert jax_record("crash_per_step")["tokens"] == jax_record("healthy")["tokens"]


def test_swap_rollback_stash_does_not_alias(env):
    """``rebind_params`` writes into the model's own tensors, so the
    swap's rollback stash must be a copy: rebind to new weights, roll
    back, and the served tensors equal the pre-swap values."""
    s = Side("torch", env)
    t = [0.0]
    fe = _swap_cluster(s, 1, lambda: t[0])
    engine = fe._handle(0).engine
    before = {k: v.clone() for k, v in engine.params.items()}
    fe.begin_swap(params=s.weights("v2"), version="v2", policy=s.SwapPolicy(
        drain_ticks=2, canary_ticks=1, canary_seconds=0.05, canary_requests=1, spot_check=True))
    _run(fe, Trail(), t, until=lambda: fe.swap_status().get("canary") == 0)
    assert s.serves(engine, "v2")  # the canary really rebound in place
    stash = fe._swap.old_params[0]
    assert all(stash[k].data_ptr() != v.data_ptr() for k, v in engine.params.items())
    fe._swap._begin_rollback("manual")
    _run(fe, Trail(), t)
    assert fe.swap_status()["state"] == "rolled_back"
    assert all(torch.equal(v, before[k]) for k, v in engine.params.items())


def test_replicas_own_their_models(env):
    """A rebind on one replica never reaches another."""
    s = Side("torch", env)
    a, b = s.engine(), s.engine()
    a.rebind_params(env.sd["v2"], version="v2")
    assert s.serves(a, "v2") and s.serves(b, "v1")


def test_validate_same_shapes_is_the_one_check(env):
    """``rebind_params`` and ``begin_swap`` refuse through the same
    ``validate_same_shapes`` message."""
    s = Side("torch", env)
    bad = dict(env.sd["v2"])
    key = sorted(bad)[0]
    bad[key] = bad[key][..., :1].clone()
    with pytest.raises(ValueError) as direct:
        validate_same_shapes(env.sd["v1"], bad)
    eng = s.engine()
    with pytest.raises(ValueError, match="same-shape") as rebind:
        eng.rebind_params(bad)
    assert str(direct.value) in str(rebind.value)
    fe = s.Frontend([eng])
    st = fe.begin_swap(params=bad, version="bad")
    assert st["state"] == "refused" and st["detail"] == str(direct.value)
    missing = {k: v for k, v in env.sd["v2"].items() if k != key}
    with pytest.raises(ValueError, match="structure differs"):
        validate_same_shapes(env.sd["v1"], missing)


def test_spot_check_twin_uses_shipped_weights(env):
    """The spot check replays through static ``generate()`` on a twin
    loaded from ``to_params``: it passes for the canary's own output and
    fails for another continuation."""
    from tpu_parallel_torch.models.generate import generate

    s = Side("torch", env)
    t = [0.0]
    fe = _swap_cluster(s, 1, lambda: t[0])
    fe.begin_swap(params=s.weights("v2"), version="v2", policy=s.SwapPolicy(spot_check=True))
    ctl = fe._swap
    h = fe._handle(0)
    prompt = env.prompts[2]
    model = GPTLM(tiny_test(), device="cpu", seed=None)
    model.load_state_dict(env.sd["v2"])
    cont = generate(model, torch.tensor([prompt]), max_new_tokens=5)[0].tolist()
    ctl._spot_candidate = (prompt, cont)
    assert ctl._run_spot_check(h)
    ctl._spot_candidate = (prompt, cont[:-1] + [(cont[-1] + 1) % 256])
    assert not ctl._run_spot_check(h)


# -- units on the port alone -------------------------------------------------


def test_routers_match_jax_placement(env):
    """Prefix keys, ring ownership and round-robin order agree with JAX's
    routers (host-side policy, copied) on the same prompts and ids."""
    from tpu_parallel.cluster import make_router as jmake_router
    from tpu_parallel.cluster import prefix_route_key as jkey

    buckets = (4, 8, 16)
    for p in env.prompts:
        assert prefix_route_key(p, buckets) == jkey(p, buckets)
    ids = [0, 1, 2, 5]
    ring = PrefixAffinityRouter(ids, buckets=buckets)
    jring = jmake_router("prefix", ids, buckets=buckets)
    ring.set_weight(1, 0.5)
    jring.set_weight(1, 0.5)
    ring.remove_replica(2)
    jring.remove_replica(2)
    assert [ring.owner(p) for p in env.prompts] == [jring.owner(p) for p in env.prompts]
    assert ring.weights == jring.weights
    assert make_router("rr", ids).name == jmake_router("rr", ids).name == "rr"
    assert isinstance(make_router("rr", ids), RoundRobinRouter)


def test_replica_fault_plan_and_migration_units(env):
    """A crashing replica goes DEAD and lists its orphans; a fixed-slot
    engine's migration refuses typed."""
    s = Side("torch", env)
    h = ReplicaHandle(0, s.engine(), fault_plan=FaultPlan(crash_at_tick=1))
    out = h.submit(Request(prompt=env.prompts[0], max_new_tokens=4))
    h.step()
    with pytest.raises(Exception):
        h.step()
    assert h.health == DEAD and [o.request.request_id for o in h.orphans()] == [
        out.request.request_id]
    eng = s.engine()
    assert eng.export_prefix("nope") is None
    counts = land_exports(eng, [None, None])
    assert counts == {MIGRATE_NOT_PAGED: 2}
    assert isinstance(eng, ServingEngine) and eng.scheduler.depth == 0
    assert SchedulerConfig  # the engine's own scheduler config type


@pytest.mark.parametrize("knobs", [
    dict(prefill_buckets=(4, 8, 16), prefix_cache_size=4),
    dict(prefill_buckets=(4, 8, 16), prefix_cache_size=4, kv_block_tokens=4),
    dict(prefill_buckets=(4, 8, 16), prefix_cache_size=4, kv_block_tokens=4,
         kv_radix_cache=True, kv_host_blocks=4),
], ids=["aligned_lru", "paged_lru", "radix_host"])
def test_rebind_drops_cached_prefixes(env, knobs):
    """Cached K/V is a function of the weights: after ``rebind_params`` a
    prompt the old weights cached must not hit, and its tokens equal
    static ``generate()`` under the new weights.  (The JAX engine keeps
    its prefix cache across a rebind and serves such a hit.)"""
    from tpu_parallel_torch.models.generate import generate

    s = Side("torch", env)
    eng = s.engine(**knobs)
    prompt = env.prompts[3]
    for _ in range(2):  # the second visit hits (and marks radix blocks warm)
        eng.add_request(Request(prompt=prompt, max_new_tokens=NEW))
        eng.run()
    eng.add_request(Request(prompt=env.prompts[0], max_new_tokens=NEW))
    eng.run()  # pushes a warm chain to the host tier under the radix
    assert eng._prefix is not None and (len(eng._prefix) or getattr(
        eng._prefix, "host_blocks_in_use", 0))
    eng.rebind_params(env.sd["v2"], version="v2")
    assert len(eng._prefix) == 0 and getattr(eng._prefix, "host_blocks_in_use", 0) == 0
    out = eng.add_request(Request(prompt=prompt, max_new_tokens=NEW))
    eng.run()
    model = GPTLM(tiny_test(), device="cpu", seed=None)
    model.load_state_dict(env.sd["v2"])
    assert out.tokens == generate(model, torch.tensor([prompt]), max_new_tokens=NEW)[0].tolist()
    if knobs.get("kv_block_tokens"):
        for blocks, _ in list(getattr(eng._prefix, "values", lambda: [])()):
            eng.pool.free_stored(blocks)
        eng.pool.allocator.check()


def test_begin_swap_from_a_serving_weight_set(env, tmp_path):
    """``begin_swap(checkpoint_dir=...)`` reads the port's serving weight
    set (the JAX layout's tree under JAX's digest), takes the manifest's
    version and rolls it to completion; a flipped byte refuses typed."""
    from tpu_parallel_torch.checkpoint import save_serving_weights
    from tpu_parallel_torch.cluster import SWAP_REFUSED_FINGERPRINT, SwapPolicy
    from tpu_parallel_torch.models.convert import params_to_jax

    s = Side("torch", env)
    t = [0.0]
    fe = _swap_cluster(s, 2, lambda: t[0])
    manifest = save_serving_weights(str(tmp_path), 3, params_to_jax(env.sd["v2"], tiny_test()))
    st = fe.begin_swap(checkpoint_dir=str(tmp_path), policy=SwapPolicy(
        drain_ticks=4, canary_ticks=1, canary_seconds=0.05, canary_requests=1))
    assert st["state"] == "rolling" and st["to_version"] == manifest.version == "step-3"
    _run(fe, Trail(), t, max_ticks=800)
    assert fe.swap_status()["state"] == "completed"
    assert all(s.serves(h.engine, "v2") for h in fe.replicas)
    payload = tmp_path / "weights_3" / "params.pt"
    raw = bytearray(payload.read_bytes())
    raw[len(raw) // 2] ^= 0x01
    payload.write_bytes(bytes(raw))
    refused = fe.begin_swap(checkpoint_dir=str(tmp_path), version="again")
    assert refused["state"] == "refused" and refused["verdict"] == SWAP_REFUSED_FINGERPRINT
