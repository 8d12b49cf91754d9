"""PyTorch/CUDA port of ``repro``: exact dense, sparse and fused
dense+sparse retrieval served through hand-written Hopper kernels.

The package mirrors ``repro``'s paths (``repro_torch/core/spaces.py`` is
the counterpart of ``repro/core/spaces.py``) and imports neither JAX nor
anything of ``repro``.
"""

from repro_torch.device import resolve_device

__version__ = "1.0.0"
__all__ = ["resolve_device"]
