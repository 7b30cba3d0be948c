from morphganformer_tpu_torch.checkpoint.convert import (  # noqa: F401
    from_flax,
    from_jax_train_state,
    is_jax_train_state,
    load_flax,
    to_flax,
    to_jax_train_state,
)
