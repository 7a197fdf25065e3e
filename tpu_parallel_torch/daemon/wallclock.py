"""The daemon's ONE wall-clock surface.

Everything under ``tpu_parallel_torch/serving`` and ``tpu_parallel_torch/cluster``
runs on an injectable clock — that is the determinism contract,
and it is what lets the chaos
harness replay fault storms tick-for-tick.  The daemon is the layer
that finally has to touch real time (it serves real clients on real
sockets), but it touches it HERE and nowhere else: :class:`WallClock`
is injected into the :class:`~tpu_parallel_torch.cluster.frontend.Frontend`
as its ``clock`` and into the daemon loop as its sleep source, so every
deadline, SLO window and journal timestamp flows through one swappable
object.  Tests hand the daemon a fake clock instead and the whole
recovery/drain story runs deterministically — the daemon shell stays as
testable as the core it wraps.

No other module of the daemon package reads ``time.*`` directly.
"""

from __future__ import annotations

import time


class WallClock:
    """Callable monotonic clock + sleep, the production time source.

    The daemon passes the instance itself as the frontend's ``clock``
    (it is callable) and uses :meth:`sleep` to pace the tick pump.  A
    fake replacement needs only ``__call__`` and ``sleep`` — see
    ``tests/test_torch_daemon.py``.
    """

    def __call__(self) -> float:
        return time.monotonic()

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            time.sleep(seconds)
