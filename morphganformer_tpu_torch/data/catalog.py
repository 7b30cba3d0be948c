"""Dataset and pretrained-model catalog (port of
morphganformer_tpu/data/catalog.py).

The reference's prepare_data.py catalog (:27-60, :93-185) and its
pretrained-snapshot list (loader.py:16-21). Nothing is downloaded:
`prepare` builds a catalog entry's PNG pyramid from a local folder or zip
archive, and without one raises with the entry's source URL.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import shutil
import zipfile
from typing import Optional

from morphganformer_tpu_torch.data.dataset_tool import create_from_images


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    url: Optional[str]
    md5: Optional[str]
    resolution: int
    ratio: float = 1.0


# Reference catalog (prepare_data.py:27-60).
DATASETS = {
    "ffhq": DatasetSpec(
        "ffhq", "https://drive.google.com/uc?id=1TbKvkxSyphXG0Jy4A3JNPwGPeNEMEPAE",
        None, 1024, 1.0),
    "bedrooms": DatasetSpec(
        "bedrooms", "http://dl.yf.io/lsun/scenes/bedroom_train_lmdb.zip",
        None, 256, 188 / 256),
    "cityscapes": DatasetSpec(
        "cityscapes", "https://drive.google.com/uc?id=1t9Bphol1JXOpvelxxQJG71MPlCkrptL5",
        None, 256, 0.5),
    "clevr": DatasetSpec(
        "clevr", "https://dl.fbaipublicfiles.com/clevr/CLEVR_v1.0.zip",
        None, 256, 0.75),
}

# Pretrained GANformer snapshots (loader.py:16-21).
PRETRAINED = {
    "clevr": "https://drive.google.com/uc?id=1Ss7qNZsLCBZTzaBvCvYPOTfLLRUpBqSM",
    "cityscapes": "https://drive.google.com/uc?id=1tAYNqWS9D2cRTYwNPXwCVUYDDbkZYLvq",
    "ffhq": "https://drive.google.com/uc?id=1tgs-hHaziWrh0piC2UigcLlZdhjxr0r5",
    "bedrooms": "https://drive.google.com/uc?id=1sdvsbqEdSUDnXTDrLZdB8sN81PJ9RBBo",
}


def md5_file(path, chunk=1 << 20):
    h = hashlib.md5()
    with open(path, "rb") as f:
        for b in iter(lambda: f.read(chunk), b""):
            h.update(b)
    return h.hexdigest()


def prepare(name: str, out_root: str, from_dir: Optional[str] = None,
            from_archive: Optional[str] = None):
    """Build `out_root/name/{res}/*.png` for a catalog entry from a local
    folder (`from_dir`) or zip archive (`from_archive`, unpacked beside the
    output and removed after); returns the dataset folder."""
    spec = DATASETS[name]
    out_dir = os.path.join(out_root, name)
    tmp = None
    if from_archive:
        tmp = os.path.join(out_root, f"_{name}_extract")
        os.makedirs(tmp, exist_ok=True)
        with zipfile.ZipFile(from_archive) as z:
            z.extractall(tmp)
        from_dir = tmp
    if not from_dir:
        raise ValueError(f"dataset '{name}' needs --from-dir/--from-archive "
                         f"(source: {spec.url})")
    try:
        create_from_images(out_dir, from_dir, spec.resolution)
    finally:
        if tmp:
            shutil.rmtree(tmp, ignore_errors=True)
    return out_dir
