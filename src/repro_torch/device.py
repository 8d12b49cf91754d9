"""Where the port's tensors live.

Entry points that create tensors take ``device=None``, which means the
CUDA card.  Without a card they raise unless the caller asked for the CPU
by name: the port never quietly continues on the CPU.  Functions that
receive tensors run where those tensors live.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raises RuntimeError when CUDA is asked for
    (explicitly or by default) and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    return dev
