"""Runtime of the port: device selection, the process group, meshes."""

from tpu_parallel_torch.runtime.bootstrap import (
    initialize,
    is_simulated,
    process_info,
    spawn_cpu_ranks,
)
from tpu_parallel_torch.runtime.device import resolve_device
from tpu_parallel_torch.runtime.mesh import (
    AXIS_ORDER,
    DATA_AXIS,
    MODEL_AXIS,
    PIPE_AXIS,
    SEQ_AXIS,
    MeshConfig,
    factor_mesh,
    make_mesh,
    mesh_from_sizes,
)

__all__ = [
    "initialize",
    "is_simulated",
    "process_info",
    "spawn_cpu_ranks",
    "resolve_device",
    "AXIS_ORDER",
    "DATA_AXIS",
    "MODEL_AXIS",
    "PIPE_AXIS",
    "SEQ_AXIS",
    "MeshConfig",
    "factor_mesh",
    "make_mesh",
    "mesh_from_sizes",
]
