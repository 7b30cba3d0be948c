from morphganformer_tpu_torch.models.config import (  # noqa: F401
    AttentionConfig,
    GANformerConfig,
    MappingConfig,
    ffhq256_config,
    ffhq1024_config,
)
from morphganformer_tpu_torch.models.generator import (  # noqa: F401
    Generator,
    init_generator,
    set_compute_dtype,
)
