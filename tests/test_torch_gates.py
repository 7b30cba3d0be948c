"""The fused gates admit only what the kernels take.

`packed_structural_ok` (G) and `packed_d_block_eligible` (D) send a block
to the fused kernels only when every kernel it would launch takes its
operands: a 4-tap FIR (K2, K3) and channel counts in fours (K1, K2, K3 read
channels with 16-byte copies). On a card the wrappers raise on anything
else, with no fallback, so a block the gates wrongly admitted would stop
the forward; a refused block runs the unfused path, as JAX's gate sends it
to XLA.

For FFHQ-1024, FFHQ-1024 with `resample_kernel=(1, 2, 1)` and with
`channel_base=1<<11` (widths 8, 4, 2 at b256-b1024), G and D: every
admitted block's operands pass the checks the CUDA wrappers make
(`upconv2_leastwork`, `upconv2_adjoint_leastwork`, `downconv2_leastwork`,
`downconv2_adjoint_leastwork` and K1's width check), and the admitted
blocks are exactly the expected ones. Then small generators and a 1024^2
discriminator of tiny widths run forward on the CPU with the fused entry
points replaced by ones that make the card's checks first: every block the
gates refuse runs unfused, and the output matches the wholly unfused path
(`force_unpacked()`) to 2e-4 of its largest entry, the JAX suite's own
tolerance for packed against unpacked networks
(tests/test_packed_pipeline.py:95): the plain fused versions sum in another
order, and a random discriminator's logit cancels most of its terms."""

import pytest
import torch

from morphganformer_tpu_torch.models import config as tcfg
from morphganformer_tpu_torch.models import discriminator as tdisc
from morphganformer_tpu_torch.models import init_generator
from morphganformer_tpu_torch.models import layers as tlayers
from morphganformer_tpu_torch.models import synthesis as tsyn
from morphganformer_tpu_torch.ops import fused_conv as fc
from morphganformer_tpu_torch.ops import setup_filter
from morphganformer_tpu_torch.ops.packed_override import force_unpacked

from .test_torch_kernels_cuda import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

OVERRIDES = {"ffhq": {}, "fir3": dict(resample_kernel=(1, 2, 1)),
             "narrow": dict(channel_base=1 << 11)}


def _weights(kh, cin, cout):
    return torch.zeros(kh, kh, cin, cout)


def card_accepts_k2(w, f):
    """K2's forward and its K3 adjoint as the CUDA wrappers check them."""
    for wk, fk, _ in (fc.upconv2_leastwork(w, f), fc.upconv2_adjoint_leastwork(w, f)):
        fc._lw_weights(wk, fk, w.device)


def card_accepts_k3(w, f):
    """K3's forward and its K2 use_dw adjoint as the CUDA wrappers check them."""
    for wk, fk, _ in (fc.downconv2_leastwork(w, f), fc.downconv2_adjoint_leastwork(w, f)):
        fc._lw_weights(wk, fk, w.device)


def card_accepts_k1(w):
    fc.k1_widths(w.shape[2], w.shape[3])


@pytest.mark.parametrize("name", OVERRIDES)
def test_g_gate_admits_what_the_kernels_take(name):
    cfg = tcfg.ffhq1024_config(**OVERRIDES[name])
    f = setup_filter(list(cfg.resample_kernel))
    admitted = [r for r in cfg.block_resolutions if tsyn.packed_structural_ok(cfg, r, "const")]
    assert admitted == {"ffhq": [256, 512, 1024], "fir3": [], "narrow": [256, 512]}[name]
    for res in admitted:
        cin, cout = cfg.channels(res // 2), cfg.channels(res)
        card_accepts_k2(_weights(3, cin, cout), f)             # conv0
        card_accepts_k2(_weights(1, cin, cout), f)             # skip
        card_accepts_k1(_weights(3, cout, cout))               # conv1, conv_last


@pytest.mark.parametrize("name", OVERRIDES)
def test_d_gate_admits_what_the_kernels_take(name):
    cfg = tcfg.DiscriminatorConfig(**OVERRIDES[name])
    f = setup_filter(list(cfg.resample_kernel))
    admitted = [r for r in cfg.block_resolutions if tdisc.packed_d_block_eligible(cfg, r)]
    assert admitted == {"ffhq": [1024, 512], "fir3": [], "narrow": [512]}[name]
    for res in admitted:
        cin, cout = cfg.channels(res), cfg.channels(res // 2)
        card_accepts_k3(_weights(3, cin, cout), f)             # conv1
        card_accepts_k3(_weights(1, cin, cout), f)             # skip
        card_accepts_k1(_weights(3, cin, cin))                 # conv0


@pytest.mark.parametrize("name", OVERRIDES)
def test_refused_widths_and_firs_fail_the_card_checks(name):
    """The other side: each block the gates refuse has an operand that a
    CUDA wrapper would raise on."""
    g, d = tcfg.ffhq1024_config(**OVERRIDES[name]), tcfg.DiscriminatorConfig(**OVERRIDES[name])
    f = setup_filter(list(g.resample_kernel))
    refused = [(r, g.channels(r // 2), g.channels(r)) for r in g.block_resolutions
               if tsyn.packed_structural_ok(g, r, "const") is False and r > 4
               and not g.use_attention(r)]
    refused += [(r, d.channels(r), d.channels(r // 2)) for r in d.block_resolutions
                if r >= 512 and not tdisc.packed_d_block_eligible(d, r)]
    assert len(refused) == {"ffhq": 0, "fir3": 5, "narrow": 2}[name]
    for _, cin, cout in refused:
        with pytest.raises(ValueError):
            card_accepts_k2(_weights(3, cin, cout), f)


class CardChecks:
    """The fused entry points, with the card's operand checks made first."""

    def __init__(self, monkeypatch):
        self.calls = []
        real = {"up": tlayers.fused_upconv2, "mod": tlayers.fused_modconv3x3,
                "down": tlayers.fused_downconv2}

        def up(x, w, styles, f, *a, **k):
            card_accepts_k2(w, f)
            self.calls.append(("up", x.shape[1]))
            return real["up"](x, w, styles, f, *a, **k)

        def mod(x, w, *a, **k):
            card_accepts_k1(w)
            self.calls.append(("mod", x.shape[1]))
            return real["mod"](x, w, *a, **k)

        def down(x, w, f, *a, **k):
            card_accepts_k3(w, f)
            self.calls.append(("down", x.shape[1]))
            return real["down"](x, w, f, *a, **k)

        for mod_ in (tlayers, tsyn):
            for name, fn in (("fused_upconv2", up), ("fused_modconv3x3", mod)):
                monkeypatch.setattr(mod_, name, fn)
        monkeypatch.setattr(tlayers, "fused_downconv2", down)


def _rel_close(got, want, tol=2e-4):
    assert (got - want).abs().max().item() <= tol * want.abs().max().item()


# Small generators with the 1024^2 block structure (fused blocks from 8^2
# up, 16 -> 8 -> 4 -> 2 channels with channel_base 64): the 4 -> 2 block
# b32 is refused by its widths, every block by the 3-tap FIR.
G_SMALL = {"narrow": (dict(channel_base=64), [8, 16]),
           "fir3": (dict(channel_base=256, resample_kernel=(1, 2, 1)), [])}


@pytest.mark.parametrize("name", G_SMALL)
def test_refused_g_blocks_run_unfused(monkeypatch, name):
    override, fused = G_SMALL[name]
    cfg = tcfg.GANformerConfig(img_resolution=32, z_dim=8, w_dim=8, k=3, channel_max=32,
                               end_res=3, mapping=tcfg.MappingConfig(num_layers=2),
                               attention=tcfg.AttentionConfig(), **override)
    assert [r for r in cfg.block_resolutions if tsyn.packed_structural_ok(cfg, r, "const")] \
        == fused
    G = init_generator(cfg, seed=0, device="cpu")
    for m in G.modules():
        if isinstance(m, tsyn.SynthesisLayer) and m.local_noise:
            m.noise_strength.data.fill_(0.3)
    z = torch.randn(2, cfg.k, cfg.z_dim, generator=torch.Generator().manual_seed(1))
    checks = CardChecks(monkeypatch)
    with torch.no_grad():
        got = G(z, truncation_psi=0.7)
        with force_unpacked():
            want = G(z, truncation_psi=0.7)
    # Per fused block: conv0 and skip on K2, conv1 on K1 (and conv_last at
    # the last block); nothing else.
    want_calls = sorted([("up", r // 2) for r in fused] * 2 + [("mod", r) for r in fused]
                        + [("mod", r) for r in fused if r == cfg.img_resolution])
    assert sorted(checks.calls) == want_calls
    _rel_close(got, want)


@pytest.mark.parametrize("name", ["narrow", "fir3"])
def test_refused_d_blocks_run_unfused(monkeypatch, name):
    """A 1024^2 discriminator of tiny widths (channel_base 2^11: 2 -> 4 at
    b1024, refused; 4 -> 8 at b512, fused), and with the 3-tap FIR (none
    fused), forward at batch 2."""
    cfg = tcfg.DiscriminatorConfig(img_resolution=1024, mbstd_group_size=2,
                                   **dict(OVERRIDES[name], channel_base=1 << 11))
    fused = [r for r in cfg.block_resolutions if tdisc.packed_d_block_eligible(cfg, r)]
    assert fused == ([512] if name == "narrow" else [])
    D = tdisc.init_discriminator(cfg, seed=0, device="cpu")
    img = torch.randn(2, 1024, 1024, 3, generator=torch.Generator().manual_seed(2))
    checks = CardChecks(monkeypatch)
    with torch.no_grad():
        got = D(img)
        with force_unpacked():
            want = D(img)
    assert sorted(checks.calls) == sorted([("down", r) for r in fused] * 2
                                          + [("mod", r) for r in fused])
    _rel_close(got, want)
