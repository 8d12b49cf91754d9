"""The port's distributed layer (counterpart of ``repro.distributed``):
the one-device ``ParallelCtx`` and the straggler monitor so far;
``mesh_utils`` and the collectives wait for the distributed slice."""

from repro_torch.distributed.sharding import ParallelCtx, params_sharding  # noqa: F401
