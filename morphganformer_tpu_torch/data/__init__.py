from morphganformer_tpu_torch.data.dataset import (  # noqa: F401
    ImageFolderDataset,
    infinite_batches,
)
