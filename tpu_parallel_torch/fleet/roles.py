"""Daemon roles for prefill/decode disaggregation (docs/14_fleet.md).

A fleet daemon advertises ONE role, chosen at config time and carried
on every ``/healthz`` response so the router never routes blind:

- ``prefill`` — takes new client submissions, computes the prompt's KV,
  and (when a decode-role peer exists) hands the stream off at
  first-token time.  A prefill daemon CAN decode — colocated decode is
  the typed fallback when the handoff cannot land — so the
  disaggregated path can never lose what the colocated path served.
- ``decode``  — takes only handoff continuations (forced-prefix
  replays whose prompt KV was shipped ahead over the wire).  A new
  client submission aimed at it is a typed ``role`` refusal, never
  breaker evidence: the daemon is healthy, it is just not that kind of
  daemon.
- ``mixed``   — the colocated behavior: both phases colocated.  A fleet of
  all-mixed daemons never disaggregates; disaggregation activates when
  the topology holds at least one prefill AND one decode role.

The module is deliberately tiny and dependency-free: the daemon config
validates against it, the router filters placement with it, and
it stays the single role vocabulary (a second role spelling would let the router and a daemon
disagree about what a peer is for).
"""

from __future__ import annotations

from typing import Mapping

ROLE_PREFILL = "prefill"
ROLE_DECODE = "decode"
ROLE_MIXED = "mixed"

ROLES = (ROLE_PREFILL, ROLE_DECODE, ROLE_MIXED)

# the daemon's typed submit-refusal reason when a decode-role daemon is
# offered a non-continuation submission (maps to 503: route elsewhere)
REJECT_ROLE = "role"

# the body field a router-issued handoff continuation carries so a
# decode-role daemon can tell replays from misrouted fresh work
PHASE_DECODE = "decode"

# fleet_role{peer} gauge encoding (docs/11_observability.md)
ROLE_GAUGE = {ROLE_MIXED: 0.0, ROLE_PREFILL: 1.0, ROLE_DECODE: 2.0}

__all__ = [
    "ROLE_PREFILL",
    "ROLE_DECODE",
    "ROLE_MIXED",
    "ROLES",
    "REJECT_ROLE",
    "PHASE_DECODE",
    "ROLE_GAUGE",
    "validate_role",
    "can_prefill",
    "can_decode",
    "disaggregated",
]


def validate_role(role: str) -> str:
    """The one role parser: every config/wire surface funnels through
    here so a typo'd role is a loud ValueError, not a daemon that
    silently never receives traffic."""
    if role not in ROLES:
        raise ValueError(f"role={role!r} not in {ROLES}")
    return role


def can_prefill(role: str) -> bool:
    """May this role take a NEW client submission?"""
    return role in (ROLE_PREFILL, ROLE_MIXED)


def can_decode(role: str) -> bool:
    """May this role take a decode continuation?"""
    return role in (ROLE_DECODE, ROLE_MIXED)


def disaggregated(roles: Mapping[str, str]) -> bool:
    """Whether a role map (addr -> role) forms a disaggregated
    topology: at least one prefill-role and one decode-role member.
    All-mixed fleets (and degenerate all-prefill / all-decode ones)
    run the colocated path."""
    values = set(roles.values())
    return ROLE_PREFILL in values and ROLE_DECODE in values
