"""The port's distributed layer (counterpart of ``repro.distributed``):
SPMD over a ``torch.distributed`` process group, a ``DeviceMesh`` behind
``ParallelCtx``, the collectives, elastic re-meshing and the straggler
monitor."""

from repro_torch.distributed.sharding import ParallelCtx, params_sharding  # noqa: F401
from repro_torch.distributed.mesh_utils import make_mesh, local_mesh  # noqa: F401
