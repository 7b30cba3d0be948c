from morphganformer_tpu_torch.checkpoint.convert import from_flax, load_flax  # noqa: F401
