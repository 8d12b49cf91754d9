"""The port's models (counterpart of ``repro.models``): the transformer
layers, the mixture-of-experts layer (one device), the backbone with its
loss and decode / prefill steps, the encoder heads, the recommendation
models (Wide&Deep, DIN, DIEN, BST) and SchNet."""

from repro_torch.models import layers, moe, transformer, encoder, recsys, schnet  # noqa: F401
