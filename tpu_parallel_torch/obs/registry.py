"""Process-local metric registry: labeled counters, gauges, and
log-bucketed histograms.

The one metric store every subsystem shares.  ``ServingMetrics`` derives
its TTFT/ITL/queue-depth percentiles from histograms registered here, the
trainer publishes MFU and throughput gauges into the same registry, and
the exporters (the JAX package's ``obs/exporters.py``, not ported yet)
serialize one :meth:`snapshot` in Prometheus text / JSONL form — the
instrument API is the only write path, so every consumer sees the same
numbers.

Design constraints, in order:

- **Bounded memory.**  A long-lived engine must not grow state per
  observation.  Counters and gauges are O(1); histograms are LOG-bucketed
  (geometric bucket edges ``growth**i``), so a histogram's size is
  O(log(max/min) / log(growth)) regardless of observation count — ~290
  buckets span 1 ns..1000 s at the default 10% growth — while bucket
  COUNTS, ``sum``, ``count``, ``min`` and ``max`` stay exact.
- **Bounded error.**  A percentile estimate is the geometric midpoint of
  the bucket holding the target rank: always within one bucket width
  (±5% relative at the default growth) of the true order statistic.
  Means are exact (``sum / count``), unlike the sliding-window deques
  this replaces, whose "mean" silently covered only the newest samples.
- **Labels without cardinality surprises.**  Instruments are keyed by
  ``(name, sorted label items)``; asking for the same pair returns the
  same object, so hot paths can hold the instrument and skip the dict
  lookup entirely.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

_LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, object]) -> _LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class Counter:
    """Monotone accumulator.  ``inc`` only — a counter that can go down is
    a gauge and would break rate() math in any downstream scraper."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter increment {amount} < 0 (use a gauge)")
        self.value += amount


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount


class Histogram:
    """Log-bucketed distribution: exact count/sum/min/max, bucket counts
    keyed by ``floor(log(v) / log(growth))`` in a sparse dict (only hit
    buckets exist), non-positive observations pooled in a dedicated zero
    bucket.  ``percentile`` answers from bucket boundaries — within one
    bucket width of the true value by construction."""

    __slots__ = ("growth", "count", "sum", "min", "max", "buckets",
                 "zero_count", "_log_growth")

    def __init__(self, growth: float = 1.1):
        if growth <= 1.0:
            raise ValueError(f"growth={growth} must be > 1")
        self.growth = growth
        self._log_growth = math.log(growth)
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self.buckets: Dict[int, int] = {}
        self.zero_count = 0

    def observe(self, value: float) -> None:
        self.count += 1
        self.sum += value
        if self.min is None or value < self.min:
            self.min = value
        if self.max is None or value > self.max:
            self.max = value
        if value <= 0.0:
            self.zero_count += 1
            return
        idx = math.floor(math.log(value) / self._log_growth)
        # float edge case: log/floor can land one bucket low when value
        # sits exactly on an edge — nudge up so value < growth**(idx+1)
        if value >= self.growth ** (idx + 1):
            idx += 1
        self.buckets[idx] = self.buckets.get(idx, 0) + 1

    def mean(self) -> Optional[float]:
        return (self.sum / self.count) if self.count else None

    def bucket_bounds(self, idx: int) -> Tuple[float, float]:
        """[lower, upper) value bounds of bucket ``idx``."""
        return self.growth ** idx, self.growth ** (idx + 1)

    def percentile(self, p: float) -> Optional[float]:
        """Geometric midpoint of the bucket containing the rank-``p``
        observation (p clamped into [0, 100]); None when empty."""
        if self.count == 0:
            return None
        p = min(max(p, 0.0), 100.0)
        # rank of the order statistic numpy's linear interpolation pivots
        # on; ceil'd to a whole observation since buckets hold counts
        rank = min(self.count, max(1, math.ceil(p / 100.0 * self.count)))
        seen = self.zero_count
        if rank <= seen:
            return 0.0
        for idx in sorted(self.buckets):
            seen += self.buckets[idx]
            if rank <= seen:
                lo, hi = self.bucket_bounds(idx)
                return math.sqrt(lo * hi)
        return self.max  # unreachable unless float drift; max is safe

    def cumulative(self) -> List[Tuple[float, int]]:
        """Ascending ``(upper_edge, cumulative_count)`` pairs — the
        Prometheus ``le`` view.  The zero bucket reports at edge 0.0."""
        out: List[Tuple[float, int]] = []
        seen = 0
        if self.zero_count:
            seen = self.zero_count
            out.append((0.0, seen))
        for idx in sorted(self.buckets):
            seen += self.buckets[idx]
            out.append((self.growth ** (idx + 1), seen))
        return out


class HistogramWindow:
    """Point-in-time capture of a :class:`Histogram` for WINDOWED reads.

    Registry histograms are monotone — they can never be reset without
    lying to their other writers — so any consumer that needs "what
    happened since T" (the swap controller's pre-swap latency baseline
    and per-canary windows, a bench's measure-after-warmup read) captures
    a window at T and reads deltas against the live instrument:

    - :meth:`base_count` / :meth:`base_mean`: the distribution AT capture
      (the swap controller's "before" side).
    - :meth:`delta_count` / :meth:`delta_mean`: observations landed SINCE
      capture (the "after" side).  Exact, like the histogram's own
      count/sum.

    The window holds only two floats — capturing is free and windows can
    be re-captured per phase (one monotone canary histogram serves every
    rollout step through a fresh window each time).
    """

    __slots__ = ("hist", "count0", "sum0")

    def __init__(self, hist: Histogram):
        self.hist = hist
        self.count0 = hist.count
        self.sum0 = hist.sum

    def base_count(self) -> int:
        return self.count0

    def base_mean(self) -> Optional[float]:
        """Mean of everything observed BEFORE capture; None when empty."""
        return (self.sum0 / self.count0) if self.count0 else None

    def delta_count(self) -> int:
        return self.hist.count - self.count0

    def delta_mean(self) -> Optional[float]:
        """Mean of everything observed SINCE capture; None when empty."""
        dc = self.delta_count()
        return ((self.hist.sum - self.sum0) / dc) if dc else None


class PercentileWindow(HistogramWindow):
    """A :class:`HistogramWindow` that also snapshots the BUCKET counts,
    so windowed PERCENTILES — not just means — read as deltas.

    The base window's two-float capture answers "what is the mean since
    T"; an SLO controller needs "what is the p95 since T" (a mean hides
    exactly the tail an overload fattens).  Capturing the sparse bucket
    dict costs O(hit buckets) — fine for a consumer that re-captures once
    per decision window (the cluster autopilot), wasteful for one that
    captures per observation.  The swap controller keeps the cheap base
    class; the autopilot uses this one.

    Counter-reset hygiene matters here too: a window holds a reference to
    the HISTOGRAM OBJECT, not to a registry name, so an
    ``engine.reset_metrics()`` mid-window (which installs a fresh
    registry and fresh instruments) leaves the window reading the old,
    now-unwritten instrument — deltas freeze at their last value and can
    never go negative (pinned in ``tests/test_obs.py``).
    """

    __slots__ = ("buckets0", "zero0")

    def __init__(self, hist: Histogram):
        super().__init__(hist)
        self.buckets0 = dict(hist.buckets)
        self.zero0 = hist.zero_count

    def delta_percentile(self, p: float) -> Optional[float]:
        """Percentile over observations landed SINCE capture — the same
        bucket-midpoint estimate as :meth:`Histogram.percentile`, on the
        bucket-count deltas; None when the window is empty."""
        h = self.hist
        dc = self.delta_count()
        if dc <= 0:
            return None
        p = min(max(p, 0.0), 100.0)
        rank = min(dc, max(1, math.ceil(p / 100.0 * dc)))
        seen = h.zero_count - self.zero0
        if rank <= seen:
            return 0.0
        for idx in sorted(h.buckets):
            seen += h.buckets[idx] - self.buckets0.get(idx, 0)
            if rank <= seen:
                lo, hi = h.bucket_bounds(idx)
                return math.sqrt(lo * hi)
        return h.max  # unreachable unless float drift; max is safe


class MetricRegistry:
    """Get-or-create store of labeled instruments.

    ``counter("requests_total", status="finished")`` returns THE counter
    for that (name, labels) pair — hold the reference on hot paths.  One
    name maps to one instrument kind; reusing a name across kinds raises
    (it would silently fork the metric in every exporter).
    """

    def __init__(self):
        self._instruments: Dict[str, Dict[_LabelKey, object]] = {}
        self._kinds: Dict[str, str] = {}
        self._hist_growth: Dict[str, float] = {}

    def _get(self, kind: str, name: str, labels: Dict[str, object],
             factory):
        have = self._kinds.setdefault(name, kind)
        if have != kind:
            raise ValueError(
                f"metric {name!r} already registered as a {have}, "
                f"requested as a {kind}"
            )
        by_label = self._instruments.setdefault(name, {})
        key = _label_key(labels)
        inst = by_label.get(key)
        if inst is None:
            inst = by_label[key] = factory()
        return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", name, labels, Counter)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", name, labels, Gauge)

    def histogram(self, name: str, growth: float = 1.1, **labels) -> Histogram:
        prior = self._hist_growth.setdefault(name, growth)
        if prior != growth:
            raise ValueError(
                f"histogram {name!r} growth {growth} != first-registered "
                f"{prior} (label series must share buckets)"
            )
        return self._get(
            "histogram", name, labels, lambda: Histogram(growth)
        )

    def snapshot(self) -> Dict[str, list]:
        """JSON-serializable dump of every instrument: the one structure
        the exporters (Prometheus text, JSONL sink) and the serve_bench
        ``--smoke`` schema gate consume."""
        out: Dict[str, list] = {"counters": [], "gauges": [], "histograms": []}
        for name, by_label in sorted(self._instruments.items()):
            kind = self._kinds[name]
            for key, inst in sorted(by_label.items()):
                labels = dict(key)
                if kind == "counter":
                    out["counters"].append(
                        {"name": name, "labels": labels, "value": inst.value}
                    )
                elif kind == "gauge":
                    out["gauges"].append(
                        {"name": name, "labels": labels, "value": inst.value}
                    )
                else:
                    out["histograms"].append(
                        {
                            "name": name,
                            "labels": labels,
                            "count": inst.count,
                            "sum": inst.sum,
                            "min": inst.min,
                            "max": inst.max,
                            "buckets": [
                                [edge, c] for edge, c in inst.cumulative()
                            ],
                        }
                    )
        return out


def validate_snapshot(snap: Dict) -> List[str]:
    """Schema check for :meth:`MetricRegistry.snapshot` output; returns a
    list of problems (empty = valid).  The serve_bench ``--smoke`` gate
    fails nonzero on any entry, so exporter consumers can rely on the
    shape without defensive parsing."""
    problems: List[str] = []
    if not isinstance(snap, dict):
        return [f"snapshot is {type(snap).__name__}, not dict"]
    for section in ("counters", "gauges", "histograms"):
        rows = snap.get(section)
        if not isinstance(rows, list):
            problems.append(f"missing/invalid section {section!r}")
            continue
        for row in rows:
            name = row.get("name")
            if not isinstance(name, str) or not name:
                problems.append(f"{section}: unnamed entry {row!r}")
                continue
            if not isinstance(row.get("labels"), dict):
                problems.append(f"{section}/{name}: labels not a dict")
            if section in ("counters", "gauges"):
                if not isinstance(row.get("value"), (int, float)):
                    problems.append(f"{section}/{name}: non-numeric value")
                continue
            for field in ("count", "sum"):
                if not isinstance(row.get(field), (int, float)):
                    problems.append(f"histograms/{name}: bad {field!r}")
            buckets = row.get("buckets")
            if not isinstance(buckets, list) or not all(
                isinstance(b, (list, tuple))
                and len(b) == 2
                and all(isinstance(x, (int, float)) for x in b)
                for b in buckets
            ):
                problems.append(f"histograms/{name}: malformed buckets")
                continue
            edges = [b[0] for b in buckets]
            counts = [b[1] for b in buckets]
            if edges != sorted(edges):
                problems.append(f"histograms/{name}: edges not ascending")
            if counts != sorted(counts):
                problems.append(
                    f"histograms/{name}: cumulative counts not monotone"
                )
            if buckets and counts[-1] != row.get("count"):
                problems.append(
                    f"histograms/{name}: cumulative tail != count"
                )
    return problems
