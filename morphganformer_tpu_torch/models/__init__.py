from morphganformer_tpu_torch.models.config import (  # noqa: F401
    AttentionConfig,
    GANformerConfig,
    MappingConfig,
    ffhq256_config,
    ffhq1024_config,
)
from morphganformer_tpu_torch.models.generator import Generator, init_generator  # noqa: F401
