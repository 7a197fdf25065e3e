"""The serving fleet's role vocabulary, copied from ``tpu_parallel/fleet``
(plain Python): the daemon validates its role against it, its HTTP face
refuses a misplaced submission with ``REJECT_ROLE``, and the autopilot
re-roles through it.  The fleet's router, peers and HTTP transport are not
in the port yet.
"""

from tpu_parallel_torch.fleet.roles import (
    REJECT_ROLE,
    ROLE_DECODE,
    ROLE_GAUGE,
    ROLE_MIXED,
    ROLE_PREFILL,
    ROLES,
    validate_role,
)

__all__ = [
    "REJECT_ROLE",
    "ROLE_DECODE",
    "ROLE_GAUGE",
    "ROLE_MIXED",
    "ROLE_PREFILL",
    "ROLES",
    "validate_role",
]
