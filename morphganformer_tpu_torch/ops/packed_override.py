"""The unpacked route: every fused block and K4 off (port of
morphganformer_tpu/ops/packed_override.py).

The fused Functions and `Conv3x3Same` have once-differentiable backwards, so
second-order autograd through them raises. The two stages that need it,
path length (the gradient of a gradient norm through G) and R1 (the gradient
of a gradient penalty through D), run their forwards inside
`force_unpacked()`: the nets then give every block the unfused plain
PyTorch path and `conv2d_resample` never takes K4, so autograd can
differentiate the whole forward twice. The stages run every 4th and 16th
iteration (lazy regularisation).

The flag is a context variable, read by `SynthesisNetwork.forward`,
`Discriminator.forward` and `conv3x3_eligible` while the forward runs: it
holds per thread, and the graph it built keeps its route after the context
is left.
"""

from __future__ import annotations

import contextlib
import contextvars

_FORCE_UNPACKED = contextvars.ContextVar("mgt_force_unpacked", default=False)


def packed_paths_disabled() -> bool:
    return _FORCE_UNPACKED.get()


@contextlib.contextmanager
def force_unpacked():
    token = _FORCE_UNPACKED.set(True)
    try:
        yield
    finally:
        _FORCE_UNPACKED.reset(token)
