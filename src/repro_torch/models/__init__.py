"""The port's models (counterpart of ``repro.models``): the transformer
layers, the backbone and the encoder heads, the recommendation models
(Wide&Deep, DIN, DIEN, BST) and SchNet.  ``moe`` is not ported yet."""

from repro_torch.models import layers, transformer, encoder, recsys, schnet  # noqa: F401
