from morphganformer_tpu_torch.morph.morpher import (  # noqa: F401
    demorph_latent,
    load_latent_mat,
    morph_latents,
    save_latent_mat,
)
