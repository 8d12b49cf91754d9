"""The port's models (counterpart of ``repro.models``): the transformer
layers, the backbone and the encoder heads.  ``moe``, ``recsys`` and
``schnet`` are not ported yet."""

from repro_torch.models import layers, transformer, encoder  # noqa: F401
