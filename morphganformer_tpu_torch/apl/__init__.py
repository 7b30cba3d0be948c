"""Adaptive Posterior Learning (APL): an episodic kNN memory and its
relational decoder (port of morphganformer_tpu/apl/). The morph pipeline
does not use it, in the reference either; it is ported so that the port
holds every module of the JAX package. The memory is a dataclass of device
tensors with pure update and query functions, so an episode stays on the
device."""

from morphganformer_tpu_torch.apl.memory import (
    MemoryState,
    add_entries,
    flush,
    init_memory,
    nearest_entries,
    num_entries,
)
from morphganformer_tpu_torch.apl.models import (
    MHDPA,
    Encoder,
    NormMLP,
    ResidualTransform,
    RSAFFDecoder,
    from_flax,
)

__all__ = [
    "MemoryState", "init_memory", "add_entries", "nearest_entries", "flush",
    "num_entries", "MHDPA", "NormMLP", "ResidualTransform", "RSAFFDecoder",
    "Encoder", "from_flax",
]
