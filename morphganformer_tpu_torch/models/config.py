"""Static architecture configuration for the GANformer generator/discriminator.

A copy of `morphganformer_tpu/models/config.py`: the port cannot import the
JAX package (its `__init__` imports flax), and the two must serialise the
same `arch.json`, so `to_json()` here matches the JAX one field for field
(tests/test_torch_config.py holds them together).
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MappingConfig:
    """Mapping network options (reference networks.py:833-892)."""
    num_layers: int = 8
    layer_dim: Optional[int] = None       # None = w_dim
    embed_dim: Optional[int] = None       # None = z_dim (only used when c_dim > 0)
    act: str = "lrelu"
    lrmul: float = 0.01
    w_avg_beta: Optional[float] = 0.995   # None = don't track
    resnet: bool = True
    shared: bool = False
    ltnt2ltnt: bool = True                # latent self-attention in mapping
    ltnt_gate: bool = False
    normalize_global: bool = True
    use_pos: bool = True
    # Run the global + component MLP chains as one batched computation
    # (identical math and param tree; applies when the chains are
    # structurally identical: resnet, no labels, not shared).
    fused: bool = True


@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    """Duplex-attention options (reference networks.py:558-622)."""
    num_heads: int = 1
    dropout: float = 0.12
    integration: str = "mul"              # "add" | "mul" | "both"
    norm: Optional[str] = "layer"         # None | "instance" | "layer"
    kmeans: bool = True
    kmeans_iters: int = 1
    iterative: bool = False               # carry centroids across layers
    ltnt_gate: bool = False
    img_gate: bool = False
    # Positional encoding of the image grid (reference networks.py:458-483).
    pos_dim: Optional[int] = None         # None = w_dim
    pos_type: str = "sinus"               # sinus | linear | trainable | trainable2d
    pos_init: str = "uniform"
    pos_directions_num: int = 2


@dataclasses.dataclass(frozen=True)
class GANformerConfig:
    """Full generator architecture (reference Generator, networks.py:1269-1331).

    The pretrained FFHQ-1024 settings (SURVEY.md §2.3): k=17 (16 local + 1
    global), z_dim=w_dim=32 per component, attention over resolutions
    [2^start_res, 2^end_res) = [4..128], integration="mul", norm="layer",
    kmeans duplex attention, resnet mapping with latent self-attention.
    """
    # Latents
    z_dim: int = 32
    c_dim: int = 0
    w_dim: int = 32
    k: int = 17                           # components (incl. 1 global)
    # Image
    img_resolution: int = 1024
    img_channels: int = 3
    # Synthesis topology
    channel_base: int = 32 << 10
    channel_max: int = 512
    architecture: str = "resnet"          # "orig" | "skip" | "resnet"
    latent_stem: bool = False
    style: bool = True                    # modulated conv (False = plain GAN)
    local_noise: bool = True
    act: str = "lrelu"
    resample_kernel: Tuple[int, ...] = (1, 3, 3, 1)
    crop_ratio: Optional[float] = None    # metadata for generation CLIs
    # Transformer placement
    transformer: bool = True
    start_res: int = 0                    # log2 units
    end_res: int = 8                      # log2 units (exclusive)
    component_dropout: float = 0.0
    # Sub-configs
    mapping: MappingConfig = dataclasses.field(default_factory=MappingConfig)
    attention: AttentionConfig = dataclasses.field(default_factory=AttentionConfig)
    # Compute dtype for synthesis convs ("float32" or "bfloat16"); params
    # always live in float32.
    dtype: str = "float32"

    # ---------------- derived static structure ----------------

    def __post_init__(self):
        res = self.img_resolution
        assert res >= 4 and res & (res - 1) == 0, "img_resolution must be a power of two >= 4"
        assert self.architecture in ("orig", "skip", "resnet")

    @property
    def block_resolutions(self) -> Tuple[int, ...]:
        """4, 8, ..., img_resolution (reference networks.py:1204)."""
        return tuple(2 ** i for i in range(2, int(math.log2(self.img_resolution)) + 1))

    def channels(self, res: int) -> int:
        """Channel width at a resolution (reference networks.py:99-100)."""
        return min(self.channel_base // res, self.channel_max)

    def use_attention(self, res: int) -> bool:
        """Transformer active at res? (reference networks.py:1212)."""
        lg = int(math.log2(res))
        return self.transformer and self.start_res <= lg < self.end_res

    def block_num_conv(self, res: int) -> int:
        """Conv-layer (w-consuming) count per block (reference networks.py:1096-1130)."""
        n = 1  # conv1
        if res > 4:
            n += 1  # conv0 (up)
        elif self.latent_stem:
            n += 1  # conv_stem
        if res == self.img_resolution:
            n += 1  # conv_last (TF-compat, networks.py:1124-1130)
        return n

    def block_num_torgb(self, res: int) -> int:
        is_last = res == self.img_resolution
        return 1 if (is_last or self.architecture == "skip") else 0

    @property
    def num_ws(self) -> int:
        """Total intermediate latents (reference networks.py:1207-1218):
        sum of per-block convs, plus the last block's torgb."""
        n = sum(self.block_num_conv(r) for r in self.block_resolutions)
        n += self.block_num_torgb(self.img_resolution)
        return n

    def block_w_slices(self):
        """(start, count) per block: every block reads num_conv + num_torgb ws
        but advances the cursor by num_conv only, so each torgb shares the
        first w of the following block (reference networks.py:1244-1253)."""
        slices = []
        w_idx = 0
        for res in self.block_resolutions:
            count = self.block_num_conv(res) + self.block_num_torgb(res)
            slices.append((w_idx, count))
            w_idx += self.block_num_conv(res)
        return tuple(slices)

    # ---------------- serialization ----------------

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "GANformerConfig":
        d = json.loads(text)
        d["mapping"] = MappingConfig(**d.get("mapping", {}))
        d["attention"] = AttentionConfig(**d.get("attention", {}))
        d["resample_kernel"] = tuple(d.get("resample_kernel", (1, 3, 3, 1)))
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class DiscriminatorConfig:
    """Discriminator architecture (reference networks.py:1475-1510)."""
    c_dim: int = 0
    img_resolution: int = 1024
    img_channels: int = 3
    architecture: str = "resnet"
    channel_base: int = 32 << 10
    channel_max: int = 512
    act: str = "lrelu"
    resample_kernel: Tuple[int, ...] = (1, 3, 3, 1)
    mbstd_group_size: Optional[int] = 4
    mbstd_num_channels: int = 1
    dtype: str = "float32"

    @property
    def block_resolutions(self) -> Tuple[int, ...]:
        return tuple(2 ** i for i in range(int(math.log2(self.img_resolution)), 2, -1))

    def channels(self, res: int) -> int:
        return min(self.channel_base // res, self.channel_max)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "DiscriminatorConfig":
        d = json.loads(text)
        d["resample_kernel"] = tuple(d.get("resample_kernel", (1, 3, 3, 1)))
        return cls(**d)


def ffhq1024_config(**overrides) -> GANformerConfig:
    """The flagship FFHQ-1024 GANformer setup (SURVEY.md §2.3 constants)."""
    return dataclasses.replace(GANformerConfig(), **overrides)


def ffhq256_config(**overrides) -> GANformerConfig:
    """256^2 variant used by projection_example_* scripts."""
    return dataclasses.replace(GANformerConfig(img_resolution=256), **overrides)
