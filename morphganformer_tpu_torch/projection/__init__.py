from morphganformer_tpu_torch.projection.engine import (  # noqa: F401
    ProjectionConfig,
    ProjectionResult,
    cosine_ramp_lr,
    latent_stats,
    loss_and_grad,
    project,
    synthesize_latent,
)
