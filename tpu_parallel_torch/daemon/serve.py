"""The serving daemon as a process, and its three fast gates.

``python -m tpu_parallel_torch.daemon.serve --serve --journal J
--ready-file R`` builds a fleet of :class:`ServingEngine` replicas (each
over its own model, the weights drawn from one seed), wraps it in a
:class:`Frontend` and a :class:`ServingDaemon` with its HTTP/SSE server,
writes ``{"port", "pid"}`` to the ready file, installs the signal
contract (SIGTERM drains, a second SIGTERM forces, SIGHUP reloads) and
pumps until shut down, exiting with ``daemon.run()``'s code.  Besides
the JAX package's child flags (``--replicas``, ``--slots``, ``--grace``,
``--fsync-batch``, ``--port``, ``--io-fsync-eio N``: persistent fsync
``EIO`` from fsync N on, ``--kv-disk-dir D``: the radix + host + disk KV
hierarchy, one subdirectory per replica) it takes ``--model``
(``tiny_test`` or ``gpt2_125m``, served in fp32 so a replay is held to
static ``generate()``) and ``--device`` (default ``cuda``; without a GPU
it fails unless given ``--device cpu``).

The gates spawn that child as a real subprocess:

- ``--smoke``: start, ``/healthz``, submit over HTTP, dedupe a resubmit,
  stream to completion, ``/metricsz``, SSE replay of a finished stream,
  no leaked reservations on ``/statez``, SIGTERM, a drained exit 0 and a
  journal whose last word is a clean shutdown record.
- ``--disk-smoke``: kill -9 mid-stream, flip one seeded bit in the
  journal's last complete record, restart on the same journal: the
  damaged record is truncated, every accepted request finishes bitwise
  against the greedy reference, and each dedupe token maps to one
  submit and one terminal.
- ``--kv-disk-smoke``: spill a warm set of long headers through the
  hierarchy to the disk tier, kill -9, restart on the same disk
  directory: the manifest seeds the prefix chains and every replayed
  header hydrates through typed disk restores, tokens bitwise.

Each gate prints its problems and exits 1 when there are any.  The
seeded kill-9 soaks (``--soak``, ``--disk-faults``, ``--kv-disk``) of
the JAX package's ``scripts/daemon_bench.py`` are not here.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import shutil
import signal
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.request

PACKAGE_PARENT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

DEFAULT_NEW_TOKENS = 8
READY_TIMEOUT = 300.0
MODELS = ("tiny_test", "gpt2_125m")
WEIGHTS_SEED = 1

# the --kv-disk geometry: prefill compute worth saving (4 layers of 512
# over 96-token shared headers) and a hierarchy tight enough that the
# warm set can only live on disk
KV_DISK_MODEL = dict(d_model=512, n_layers=4, n_heads=4, seq_len=128)
KV_DISK_ENGINE = dict(
    kv_block_tokens=32, kv_pool_blocks=24, prefix_cache_size=4,
    kv_radix_cache=True, kv_host_blocks=4, kv_disk_blocks=160,
)
KV_DISK_HEADER_TOKENS = 96  # 3 full blocks of reusable tenant header
KV_DISK_NEW_TOKENS = 6


def model_config(name: str, kv_disk: bool = False):
    """The served config: fp32 at the model's published widths (the
    tiny model takes the disk tier's geometry under ``kv_disk``)."""
    import torch

    from tpu_parallel_torch.models import gpt2_125m, tiny_test

    if name == "tiny_test":
        return tiny_test(**(KV_DISK_MODEL if kv_disk else {}))
    if name == "gpt2_125m":
        return gpt2_125m(dtype=torch.float32)
    raise ValueError(f"--model {name!r}: expected one of {MODELS}")


def build_models(name: str, device: str, n: int, kv_disk: bool = False):
    """``n`` models with the same weights, drawn once from
    :data:`WEIGHTS_SEED`: one per replica, so a rebind on one replica
    never reaches another."""
    from tpu_parallel_torch.models import GPTLM

    cfg = model_config(name, kv_disk)
    first = GPTLM(cfg, device=device, seed=WEIGHTS_SEED)
    models = [first]
    for _ in range(n - 1):
        model = GPTLM(cfg, device=device, seed=None)
        model.load_state_dict(first.state_dict())
        models.append(model)
    return models


# -- HTTP client helpers -----------------------------------------------------


def http_json(method, url, body=None, timeout=120.0):
    """One JSON request; returns (status_code, payload) and never
    raises on HTTP error codes (connection errors DO raise)."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method)
    if data is not None:
        req.add_header("Content-Type", "application/json")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read() or b"{}")
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read() or b"{}")


def wait_ready(ready_file, proc, timeout=READY_TIMEOUT):
    """Poll for the child's ready file; returns its payload dict."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise RuntimeError(
                f"daemon child exited rc={proc.returncode} before ready"
            )
        if os.path.exists(ready_file):
            try:
                with open(ready_file) as fh:
                    info = json.load(fh)
                if "port" in info:
                    return info
            except (ValueError, OSError):
                pass  # mid-write
        time.sleep(0.05)
    raise RuntimeError(f"daemon child not ready within {timeout}s")


def spawn_daemon(args, journal, ready_file, extra=()):
    """Start the ``--serve`` child with this interpreter."""
    if os.path.exists(ready_file):
        os.remove(ready_file)
    cmd = [
        sys.executable, "-m", "tpu_parallel_torch.daemon.serve", "--serve",
        "--journal", journal, "--ready-file", ready_file,
        "--replicas", str(args.replicas), "--slots", str(args.slots),
        "--grace", str(args.grace), "--fsync-batch", str(args.fsync_batch),
        "--model", args.model, "--device", args.device,
        *extra,
    ]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (PACKAGE_PARENT, env.get("PYTHONPATH")) if p
    )
    return subprocess.Popen(cmd, env=env)


def stream_tokens(port, rid, timeout=180):
    """Ride a request's SSE stream to its terminal event; returns
    ``(tokens, terminal_event)``."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/stream/{rid}")
    tokens = []
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        for raw in resp:
            if not raw.startswith(b"data: "):
                continue
            ev = json.loads(raw[len(b"data: "):])
            if "token" in ev:
                tokens.append(ev["token"])
            if ev.get("finished"):
                return tokens, ev
    raise RuntimeError(f"stream for {rid} closed before the terminal")


# -- schedule + references ---------------------------------------------------


def make_schedule(seed, n_requests, new_tokens, vocab=250):
    """Seeded prompts + dedupe tokens (pure function of seed)."""
    rnd = random.Random(seed)
    schedule = []
    for i in range(n_requests):
        length = rnd.randrange(3, 12)
        prompt = [rnd.randrange(1, vocab) for _ in range(length)]
        schedule.append({
            "dedupe_token": f"soak-{seed}-{i}",
            "prompt": prompt,
            "max_new_tokens": new_tokens,
        })
    return schedule


def greedy_references(schedule, model="tiny_test", device="cuda",
                      kv_disk=False):
    """Static ``generate()`` greedy continuation of every prompt on the
    child's weights: the oracle the crash+replay output must match."""
    import torch

    from tpu_parallel_torch.models.generate import generate

    (lm,) = build_models(model, device, 1, kv_disk)
    refs = {}
    for entry in schedule:
        prompt = torch.tensor([entry["prompt"]], dtype=torch.long,
                              device=lm.device)
        cont = generate(lm, prompt, max_new_tokens=entry["max_new_tokens"])
        refs[entry["dedupe_token"]] = [int(t) for t in cont[0].tolist()]
    return refs


# -- the serve child ---------------------------------------------------------


def serve(args):
    from tpu_parallel_torch.cluster import Frontend, FrontendConfig
    from tpu_parallel_torch.daemon import (
        DaemonConfig,
        DaemonHTTPServer,
        ServingDaemon,
        iofaults,
    )
    from tpu_parallel_torch.obs.registry import MetricRegistry
    from tpu_parallel_torch.serving import SchedulerConfig, ServingEngine

    if args.io_fsync_eio >= 0:
        # the dead-disk shape: every fsync from index N on fails EIO —
        # the child must DEGRADE (typed 503s, /healthz reason), not die
        iofaults.install(iofaults.IOFaultPlan(
            fsync_eio_at=args.io_fsync_eio,
            fsync_eio_count=iofaults.PERSISTENT,
        ))
    models = build_models(args.model, args.device, args.replicas,
                          bool(args.kv_disk_dir))

    def frontend_factory(clock):
        engines = []
        for i, model in enumerate(models):
            extra_kw = {}
            if args.kv_disk_dir:
                # one store per replica: the manifest journal is a
                # single-writer file, so replicas must not share a root
                extra_kw = dict(
                    KV_DISK_ENGINE,
                    kv_disk_dir=os.path.join(args.kv_disk_dir, f"r{i}"),
                )
            engines.append(ServingEngine(
                model, n_slots=args.slots,
                scheduler=SchedulerConfig(max_prefills_per_tick=2),
                **extra_kw,
            ))
        return Frontend(
            engines, router="least",
            config=FrontendConfig(restart=None),
            clock=clock, registry=MetricRegistry(),
        )

    daemon = ServingDaemon(
        frontend_factory, args.journal,
        config=DaemonConfig(
            grace_seconds=args.grace, fsync_batch=args.fsync_batch,
        ),
    )
    server = DaemonHTTPServer(daemon, port=args.port).start()
    daemon.install_signals()
    with open(args.ready_file + ".tmp", "w") as fh:
        json.dump({"port": server.port, "pid": os.getpid()}, fh)
    os.replace(args.ready_file + ".tmp", args.ready_file)
    rc = daemon.run()
    server.stop()
    return rc


# -- invariants --------------------------------------------------------------


def journal_invariants(journal_path, problems):
    """Scan the journal the way recovery does and check the no-loss /
    no-duplicate bookkeeping.  Returns the folded state."""
    from tpu_parallel_torch.daemon import load_state

    state = load_state(journal_path)
    by_token = {}
    for rid in state.order:
        tok = state.entries[rid].dedupe_token
        if tok is not None:
            by_token.setdefault(tok, []).append(rid)
    for tok, rids in by_token.items():
        if len(rids) != 1:
            problems.append(
                f"dedupe token {tok} journaled {len(rids)} submits "
                f"({rids}) — duplicate admission"
            )
    for entry in state.unfinished:
        problems.append(
            f"request {entry.request_id} journaled accepted but never "
            "reached a terminal — lost accepted work"
        )
    return state


def state_leak_check(port, problems, label):
    code, payload = http_json("GET", f"http://127.0.0.1:{port}/statez")
    if code != 200:
        problems.append(f"{label}: /statez returned {code}")
        return
    cluster = payload["cluster"]
    if cluster["inflight_tokens"] != 0:
        problems.append(
            f"{label}: leaked token reservations: "
            f"{cluster['inflight_tokens']}"
        )
    for rep in cluster["replicas"]:
        if rep["active_slots"] or rep["queue_depth"]:
            problems.append(
                f"{label}: replica {rep['replica']} not quiesced: "
                f"slots={rep['active_slots']} queue={rep['queue_depth']}"
            )


def stop_gracefully(proc, grace, problems, label):
    proc.send_signal(signal.SIGTERM)
    try:
        rc = proc.wait(timeout=grace + 60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=30)
        problems.append(f"{label}: SIGTERM did not exit within grace")
        return
    if rc != 0:
        problems.append(f"{label}: drain exit code {rc} != 0")


def wait_terminal(port, rids, timeout=240.0):
    """Poll ``/v1/result`` until every ``{key: rid}`` is terminal;
    returns ``(finished_records, still_pending)``."""
    deadline = time.monotonic() + timeout
    done, pending = {}, dict(rids)
    while pending and time.monotonic() < deadline:
        for key, rid in list(pending.items()):
            code, rec = http_json(
                "GET", f"http://127.0.0.1:{port}/v1/result/{rid}"
            )
            if code == 200 and rec["status"] in (
                "finished", "failed", "cancelled", "rejected", "expired",
            ):
                done[key] = rec
                del pending[key]
        time.sleep(0.05)
    return done, pending


def _gate_args(device, model="tiny_test", **kw):
    base = dict(replicas=1, slots=2, grace=60.0, fsync_batch=8,
                model=model, device=device, workdir="")
    base.update(kw)
    return argparse.Namespace(**base)


# -- gates -------------------------------------------------------------------


def run_smoke(device="cuda", tmpdir=None, keep=False):
    """start -> submit -> stream -> SIGTERM drain -> clean exit.
    Returns a problem list."""
    from tpu_parallel_torch.daemon import REC_SHUTDOWN, read_journal

    problems = []
    tmpdir = tmpdir or tempfile.mkdtemp(prefix="daemon_smoke_")
    journal = os.path.join(tmpdir, "journal.jsonl")
    ready = os.path.join(tmpdir, "ready.json")
    args = _gate_args(device)
    proc = spawn_daemon(args, journal, ready)
    try:
        port = wait_ready(ready, proc)["port"]
        code, payload = http_json("GET", f"http://127.0.0.1:{port}/healthz")
        if code != 200 or not payload.get("ok"):
            problems.append(f"healthz {code}: {payload}")
        schedule = make_schedule(seed=7, n_requests=2,
                                 new_tokens=DEFAULT_NEW_TOKENS)
        rids = []
        for entry in schedule:
            code, rec = http_json(
                "POST", f"http://127.0.0.1:{port}/v1/submit", entry
            )
            if code != 200:
                problems.append(f"submit {code}: {rec}")
                continue
            rids.append(rec["request_id"])
        # idempotence: resubmitting the first token dedupes
        code, rec = http_json(
            "POST", f"http://127.0.0.1:{port}/v1/submit", schedule[0]
        )
        if code != 200 or not rids or rec["request_id"] != rids[0]:
            problems.append(f"dedupe resubmit mismatched: {code} {rec}")
        done, pending = wait_terminal(port, dict(enumerate(rids)), 120.0)
        for key, rec in done.items():
            if rec["status"] != "finished":
                problems.append(f"{rids[key]}: status {rec['status']}")
            elif len(rec["tokens"]) != DEFAULT_NEW_TOKENS:
                problems.append(
                    f"{rids[key]}: {len(rec['tokens'])} tokens != "
                    f"{DEFAULT_NEW_TOKENS}"
                )
        for key in pending:
            problems.append(f"{rids[key]}: never finished")
        with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metricsz", timeout=30
        ) as resp:
            metrics_text = resp.read().decode()
        if "daemon_journal_records_total" not in metrics_text:
            problems.append("metricsz missing daemon_* series")
        if rids:
            # SSE replay of a finished stream: N token events + a
            # finished event with the typed reason
            toks, last = stream_tokens(port, rids[0], timeout=30)
            if len(toks) != DEFAULT_NEW_TOKENS or not last.get("finished"):
                problems.append(
                    f"stream replay malformed: {len(toks)} tokens, "
                    f"tail {last}"
                )
        state_leak_check(port, problems, "smoke")
        stop_gracefully(proc, args.grace, problems, "smoke")
        records, torn = read_journal(journal)
        if torn:
            problems.append(f"{torn} torn record(s) after a clean exit")
        last = records[-1] if records else {}
        if last.get("record") != REC_SHUTDOWN or not last.get("clean"):
            problems.append(
                f"journal's last word is {last} — expected a clean "
                "shutdown record"
            )
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        if not keep and not problems:
            shutil.rmtree(tmpdir, ignore_errors=True)
    return problems


def corrupt_tail_record(journal_path, rnd):
    """Flip ONE seeded bit inside the journal's last COMPLETE record —
    the post-fsync bit-rot shape the per-record CRC exists to catch.
    Returns ``(record_kind, dedupe_token)`` of the corrupted record (a
    submit's loss re-admits via client retry; a tokens/terminal loss
    regenerates bitwise)."""
    with open(journal_path, "rb") as fh:
        data = fh.read()
    end = len(data)
    if not data.endswith(b"\n"):
        end = data.rfind(b"\n") + 1  # skip the torn fragment
    start = data.rfind(b"\n", 0, end - 1) + 1
    line = data[start:end - 1]  # the last complete record's bytes
    try:
        rec = json.loads(line)
    except ValueError:
        rec = {}
    bit = rnd.randrange(len(line) * 8)
    flipped = bytearray(line)
    flipped[bit // 8] ^= 1 << (bit % 8)
    with open(journal_path, "wb") as fh:
        fh.write(data[:start] + bytes(flipped) + data[end - 1:])
    return rec.get("record", "unparseable"), rec.get("dedupe_token")


def run_disk_trial(args, seed, refs):
    """One seeded disk-fault trial: life 1 accepts traffic and is
    SIGKILLed mid-stream; one bit of the journal's last durable record
    flips; life 2 restarts on it, must truncate the damaged record,
    dedupe the retries and finish every stream bitwise.  Returns the
    problems found."""
    from tpu_parallel_torch.daemon import read_journal

    rnd = random.Random(seed ^ 0x10FA)
    problems = []
    tmpdir = tempfile.mkdtemp(prefix=f"daemon_disk_{seed}_",
                              dir=args.workdir or None)
    journal = os.path.join(tmpdir, "journal.jsonl")
    ready = os.path.join(tmpdir, "ready.json")
    schedule = make_schedule(seed, args.requests, args.new)

    # ---- life 1: accept traffic, SIGKILL mid-stream
    proc = spawn_daemon(args, journal, ready)
    try:
        port = wait_ready(ready, proc)["port"]
        kill_after = rnd.randrange(2, max(3, args.requests))
        accepted = {}
        for i, entry in enumerate(schedule):
            try:
                code, rec = http_json(
                    "POST", f"http://127.0.0.1:{port}/v1/submit", entry
                )
            except (urllib.error.URLError, OSError):
                break
            if code == 200:
                accepted[entry["dedupe_token"]] = rec["request_id"]
            if i + 1 == kill_after:
                time.sleep(rnd.uniform(0.2, 0.6))  # let tokens stream
                break
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)

    # ---- seeded media corruption: one bit of the last durable record
    kind, corrupted_token = corrupt_tail_record(journal, rnd)
    try:
        _, pre_torn = read_journal(journal)
    except Exception as exc:  # noqa: BLE001 — any refusal is the finding
        problems.append(
            f"read_journal refused a tail-corrupted journal: {exc!r}"
        )
        pre_torn = -1
    if pre_torn == 0:
        problems.append(
            "planted bit flip was not detected as tail damage "
            f"(corrupted a {kind} record)"
        )

    # ---- life 2: restart on the corrupted journal; idempotent retries
    proc = spawn_daemon(args, journal, ready)
    try:
        port = wait_ready(ready, proc)["port"]
        _, torn = read_journal(journal)
        if torn:
            problems.append(
                f"life2: {torn} damaged record(s) survived the restart "
                "truncation"
            )
        all_rids = {}
        for entry in schedule:
            code, rec = http_json(
                "POST", f"http://127.0.0.1:{port}/v1/submit", entry
            )
            if code != 200:
                problems.append(f"life2 submit rejected {code}: {rec}")
                continue
            tok = entry["dedupe_token"]
            all_rids[tok] = rec["request_id"]
            # a retry dedupes, unless the corrupted record WAS its submit:
            # then it legitimately re-admits fresh
            if tok in accepted and tok != corrupted_token:
                if rec["request_id"] != accepted[tok]:
                    problems.append(
                        f"life2: dedupe {tok} re-admitted as "
                        f"{rec['request_id']} != {accepted[tok]} "
                        f"(corrupted record was {kind})"
                    )
        finished, pending = wait_terminal(port, all_rids)
        for tok, rid in pending.items():
            problems.append(f"{tok} ({rid}): never terminal")
        for tok, rec in finished.items():
            if rec["status"] != "finished":
                problems.append(
                    f"{tok}: status {rec['status']} "
                    f"({rec['finish_reason']}) — lost accepted work"
                )
            elif rec["tokens"] != refs[tok]:
                problems.append(
                    f"{tok}: tokens diverge from the greedy reference "
                    "through crash + media corruption"
                )
        state_leak_check(port, problems, f"disk{seed}")
        stop_gracefully(proc, args.grace, problems, f"disk{seed}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    journal_invariants(journal, problems)
    if not problems:
        shutil.rmtree(tmpdir, ignore_errors=True)
    return problems


def run_disk_smoke(device="cuda"):
    """One reduced seeded disk-fault trial."""
    args = _gate_args(device, fsync_batch=4, requests=3, new=8)
    seed = 5
    refs = greedy_references(make_schedule(seed, args.requests, args.new),
                             args.model, device)
    return run_disk_trial(args, seed, refs)


def make_kv_disk_schedule(seed, n_headers, life,
                          new_tokens=KV_DISK_NEW_TOKENS):
    """Seeded long-header schedule.  Prompts are a pure function of
    ``(seed, i)``, identical across process lives, while the dedupe
    token carries the ``life`` tag, so a restarted daemon admits the
    replay as FRESH work (restore or recompute, never a dedupe hit)."""
    rnd = random.Random(seed ^ 0x55D)
    schedule = []
    for i in range(n_headers):
        header = [rnd.randrange(1, 250) for _ in range(KV_DISK_HEADER_TOKENS)]
        suffix = [rnd.randrange(1, 250) for _ in range(2)]
        schedule.append({
            "dedupe_token": f"kvd-{seed}-{i}-{life}",
            "prompt": header + suffix,
            "max_new_tokens": new_tokens,
        })
    return schedule


def healthz_kv(port):
    _, payload = http_json("GET", f"http://127.0.0.1:{port}/healthz")
    return (payload.get("kv") or {}) if isinstance(payload, dict) else {}


def _submit_and_stream(port, entry):
    code, rec = http_json(
        "POST", f"http://127.0.0.1:{port}/v1/submit", entry
    )
    if code != 200:
        raise RuntimeError(f"submit {code}: {rec}")
    tokens, last = stream_tokens(port, rec["request_id"])
    return tokens, last.get("status")


def run_kv_disk_trial(args, seed, refs):
    """One disk-tier warm-restart trial: life 1 spills a warm set to
    disk and is SIGKILLed; the restart on the same disk directory must
    seed chains from the manifest and replay every header through
    typed disk restores, bitwise.  Returns the problems found."""
    n_headers = len(refs)
    problems = []
    tmpdir = tempfile.mkdtemp(prefix=f"daemon_kvdisk_{seed}_",
                              dir=args.workdir or None)
    journal = os.path.join(tmpdir, "journal.jsonl")
    ready = os.path.join(tmpdir, "ready.json")
    extra = ("--kv-disk-dir", os.path.join(tmpdir, "disk"))
    warmup = [3] * (KV_DISK_HEADER_TOKENS + 2)

    def check(label, i, tokens, status):
        if status != "finished":
            problems.append(f"{label}: header {i} status {status}")
        elif tokens != refs[i]:
            problems.append(
                f"{label}: header {i} tokens diverge from the greedy "
                "reference"
            )

    # ---- life 1: each header twice back to back (the second take HITS,
    # which marks its blocks warm: only warm blocks spill), then warm
    # flushers push every header block through the host tier to disk
    proc = spawn_daemon(args, journal, ready, extra=extra)
    try:
        port = wait_ready(ready, proc)["port"]
        for rep in range(2):
            _submit_and_stream(port, {
                "dedupe_token": f"kvd-{seed}-warmup-a-{rep}",
                "prompt": warmup, "max_new_tokens": KV_DISK_NEW_TOKENS,
            })
        build = [make_kv_disk_schedule(seed, n_headers, life)
                 for life in ("a0", "a1")]
        for i in range(n_headers):
            for sched in build:
                check("life1", i, *_submit_and_stream(port, sched[i]))
        frnd = random.Random(seed ^ 0xF1)
        for i in range(4):
            flusher = [250] + [frnd.randrange(1, 250)
                               for _ in range(KV_DISK_HEADER_TOKENS + 1)]
            for rep in range(2):
                _submit_and_stream(port, {
                    "dedupe_token": f"kvd-{seed}-flush-{i}-{rep}",
                    "prompt": flusher, "max_new_tokens": KV_DISK_NEW_TOKENS,
                })
        kv_life1 = healthz_kv(port)
        if kv_life1.get("disk_blocks_used", 0) < n_headers:
            problems.append(
                f"life1: {kv_life1.get('disk_blocks_used', 0)} disk blocks "
                f"< {n_headers} headers — the warm set never reached the "
                f"disk tier (healthz kv: {kv_life1})"
            )
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)

    # ---- warm leg: restart on the SAME journal + SAME disk directory
    proc = spawn_daemon(args, journal, ready, extra=extra)
    try:
        port = wait_ready(ready, proc)["port"]
        kv_seeded = healthz_kv(port)
        if not kv_seeded.get("disk_seeded_chains"):
            problems.append(
                "warm: restart seeded no prefix chains from the manifest "
                f"(healthz kv: {kv_seeded})"
            )
        for rep in range(2):
            _submit_and_stream(port, {
                "dedupe_token": f"kvd-{seed}-warmup-w-{rep}",
                "prompt": warmup, "max_new_tokens": KV_DISK_NEW_TOKENS,
            })
        for i, entry in enumerate(make_kv_disk_schedule(seed, n_headers, "w")):
            check("warm", i, *_submit_and_stream(port, entry))
        kv_warm = healthz_kv(port)
        if kv_warm.get("disk_restores", 0) < n_headers:
            problems.append(
                f"warm: {kv_warm.get('disk_restores', 0)} disk restores < "
                f"{n_headers} replayed warm chains — warm hits recomputed"
            )
        if kv_warm.get("disk_restore_failures", 0):
            problems.append(
                f"warm: {kv_warm['disk_restore_failures']} restore "
                "failures on an uncorrupted disk"
            )
        stop_gracefully(proc, args.grace, problems, f"kvdisk-warm{seed}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    if not problems:
        shutil.rmtree(tmpdir, ignore_errors=True)
    return problems


def run_kv_disk_smoke(device="cuda"):
    """One reduced warm-restart trial of the disk KV tier."""
    args = _gate_args(device, fsync_batch=4)
    seed = 11
    sched = make_kv_disk_schedule(seed, 5, "ref")
    refs = greedy_references(sched, args.model, device, kv_disk=True)
    return run_kv_disk_trial(args, seed, [refs[e["dedupe_token"]] for e in sched])


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m tpu_parallel_torch.daemon.serve"
    )
    ap.add_argument("--serve", action="store_true",
                    help="run the daemon process (needs --journal and "
                         "--ready-file)")
    ap.add_argument("--smoke", action="store_true",
                    help="fast gate: start, submit, SIGTERM drain, "
                         "assert clean exit (no kill -9)")
    ap.add_argument("--disk-smoke", action="store_true",
                    help="fast integrity gate: kill -9, one seeded tail "
                         "bit flip, bitwise recovery")
    ap.add_argument("--kv-disk-smoke", action="store_true",
                    help="fast disk-tier gate: spill, kill -9, manifest "
                         "warm start, typed restores, bitwise replay")
    ap.add_argument("--kv-disk-dir", type=str, default="",
                    help="(--serve) attach the radix + host + disk KV "
                         "hierarchy, one subdirectory per replica")
    ap.add_argument("--io-fsync-eio", type=int, default=-1,
                    help="(--serve) persistent fsync EIO from this fsync "
                         "index on")
    ap.add_argument("--journal", type=str, default="")
    ap.add_argument("--ready-file", type=str, default="")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--grace", type=float, default=60.0)
    ap.add_argument("--fsync-batch", type=int, default=8)
    ap.add_argument("--model", choices=MODELS, default="tiny_test")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    if args.serve:
        if not args.journal or not args.ready_file:
            ap.error("--serve needs --journal and --ready-file")
        return serve(args)
    if args.smoke:
        problems = run_smoke(args.device)
    elif args.disk_smoke:
        problems = run_disk_smoke(args.device)
    elif args.kv_disk_smoke:
        problems = run_kv_disk_smoke(args.device)
    else:
        ap.error("pick --serve, --smoke, --disk-smoke or --kv-disk-smoke")
    for problem in problems:
        print(problem, file=sys.stderr)
    if problems:
        print(f"serve: {len(problems)} INVARIANT VIOLATION(S)",
              file=sys.stderr)
        return 1
    print("serve: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
