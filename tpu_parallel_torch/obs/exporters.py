"""Telemetry exporters: the port of ``tpu_parallel/obs/exporters.py``
(copied; plain Python), its Chrome trace-event JSON (Perfetto) and
Prometheus text exposition.  Both read a :class:`~tpu_parallel_torch.obs.
tracer.Tracer`'s spans or a :class:`~tpu_parallel_torch.obs.registry.
MetricRegistry` snapshot, so exporting never means instrumenting.  The
label parser and the JSONL snapshot sink are not in the port yet.

Chrome trace mapping: one trace **process** per export, one **thread**
(tid) per tracer track.  Complete spans emit ``X`` events; async spans
emit ``b``/``e`` nestable pairs keyed by request id; instants emit
thread-scoped ``i`` markers.  Timestamps are microseconds.
"""

from __future__ import annotations

import json
import re
from typing import Dict, List, Union

from tpu_parallel_torch.obs.registry import MetricRegistry
from tpu_parallel_torch.obs.tracer import Tracer

# -- Chrome trace-event JSON (Perfetto / chrome://tracing) -----------------


def chrome_trace_events(tracer: Tracer, pid: int = 1) -> List[Dict]:
    """Flatten a tracer into trace-event dicts (metadata + spans +
    instants).  Unfinished spans close at the last timestamp seen, so a
    trace from an aborted run still loads."""
    events: List[Dict] = [
        {
            "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": "tpu_parallel"},
        }
    ]
    tids = {track: i for i, track in enumerate(tracer.tracks())}
    for track, tid in tids.items():
        events.append(
            {
                "ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                "args": {"name": track},
            }
        )
        # tid order == tracks() order (scheduler first, slots sorted)
        events.append(
            {
                "ph": "M", "name": "thread_sort_index", "pid": pid,
                "tid": tid, "args": {"sort_index": tid},
            }
        )
    ends = [s.end for s in tracer.spans if s.end is not None]
    ends += [s.start for s in tracer.spans]
    ends += [ev["ts"] for ev in tracer.instants]
    last_ts = max(ends) if ends else 0.0
    for span in tracer.spans:
        tid = tids[span.track]
        start_us = span.start * 1e6
        end = span.end if span.end is not None else last_ts
        args = dict(span.attrs)
        if span.async_id is not None:
            common = {
                "cat": "async", "id": str(span.async_id),
                "name": span.name, "pid": pid, "tid": tid,
            }
            events.append({"ph": "b", "ts": start_us, "args": args, **common})
            events.append({"ph": "e", "ts": end * 1e6, **common})
        else:
            events.append(
                {
                    "ph": "X", "cat": "span", "name": span.name,
                    "pid": pid, "tid": tid, "ts": start_us,
                    "dur": max(0.0, (end - span.start) * 1e6),
                    "args": args,
                }
            )
    for ev in tracer.instants:
        events.append(
            {
                "ph": "i", "s": "t", "cat": "instant", "name": ev["name"],
                "pid": pid, "tid": tids[ev["track"]], "ts": ev["ts"] * 1e6,
                "args": dict(ev["attrs"]),
            }
        )
    return events


def write_chrome_trace(tracer: Tracer, path: str) -> str:
    """Dump the tracer as a Perfetto-openable trace file; returns
    ``path``."""
    with open(path, "w") as fh:
        json.dump(
            {
                "traceEvents": chrome_trace_events(tracer),
                "displayTimeUnit": "ms",
            },
            fh,
        )
    return path


# -- Prometheus text exposition --------------------------------------------

_NAME_OK = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    name = _NAME_OK.sub("_", name)
    return name if not name[:1].isdigit() else "_" + name


def _prom_labels(labels: Dict[str, str], extra: Dict[str, str] = None) -> str:
    items = dict(labels)
    if extra:
        items.update(extra)
    if not items:
        return ""
    body = ",".join(
        '{}="{}"'.format(
            _prom_name(k),
            str(v).replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n"),
        )
        for k, v in sorted(items.items())
    )
    return "{" + body + "}"


def _prom_value(v) -> str:
    if v is None:
        return "NaN"
    f = float(v)
    return repr(int(f)) if f == int(f) else repr(f)


def prometheus_lines(snapshot: Dict) -> List[str]:
    """Render a registry snapshot as Prometheus text-exposition lines
    (``# TYPE`` headers + one sample per line; histograms expand to
    cumulative ``_bucket{le=...}`` series plus ``_sum``/``_count``)."""
    lines: List[str] = []
    typed: set = set()

    def header(name: str, kind: str) -> None:
        if name not in typed:
            typed.add(name)
            lines.append(f"# TYPE {name} {kind}")

    for row in snapshot.get("counters", []):
        name = _prom_name(row["name"])
        header(name, "counter")
        lines.append(
            f"{name}{_prom_labels(row['labels'])} {_prom_value(row['value'])}"
        )
    for row in snapshot.get("gauges", []):
        name = _prom_name(row["name"])
        header(name, "gauge")
        lines.append(
            f"{name}{_prom_labels(row['labels'])} {_prom_value(row['value'])}"
        )
    for row in snapshot.get("histograms", []):
        name = _prom_name(row["name"])
        header(name, "histogram")
        labels = row["labels"]
        for edge, cum in row["buckets"]:
            lines.append(
                f"{name}_bucket"
                f"{_prom_labels(labels, {'le': _prom_value(edge)})} {cum}"
            )
        lines.append(
            f"{name}_bucket{_prom_labels(labels, {'le': '+Inf'})} "
            f"{row['count']}"
        )
        lines.append(
            f"{name}_sum{_prom_labels(labels)} {_prom_value(row['sum'])}"
        )
        lines.append(f"{name}_count{_prom_labels(labels)} {row['count']}")
    return lines


def prometheus_text(source: Union[MetricRegistry, Dict]) -> str:
    snap = source.snapshot() if isinstance(source, MetricRegistry) else source
    return "\n".join(prometheus_lines(snap)) + "\n"


def write_prometheus(source: Union[MetricRegistry, Dict], path: str) -> str:
    """Write one text-exposition snapshot (node-exporter textfile style —
    point a file scrape at it, or re-export per tick for a live series);
    returns ``path``."""
    with open(path, "w") as fh:
        fh.write(prometheus_text(source))
    return path
