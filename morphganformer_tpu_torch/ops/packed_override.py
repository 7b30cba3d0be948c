"""The two routes that take a second derivative through the nets: the
unpacked route, every fused block and K4 off (port of
morphganformer_tpu/ops/packed_override.py), and the scope of the
second-order route (ops/second_order.py holds its policy and grad
Functions).

Outside `second_order_scope()` the fused Functions and `Conv3x3Same` have
once-differentiable backwards, so second-order autograd through them
raises. The two stages that need it, path length (the gradient of a
gradient norm through G) and R1 (the gradient of a gradient penalty
through D), run their forwards inside that scope by default: the fused
blocks keep their kernels, and their backwards become differentiable (K4
stays off there, having no second-order route). Under
MGT_PACKED_SECOND_ORDER=0 (JAX's fallback) they run inside
`force_unpacked()` instead: the nets then give every block the unfused
plain PyTorch path and `conv2d_resample` never takes K4, so autograd can
differentiate the whole forward twice. The stages run every 4th and 16th
iteration (lazy regularisation).

Both flags are context variables, read by `SynthesisNetwork.forward`,
`Discriminator.forward`, `conv3x3_eligible` and the fused Functions while
the forward runs: they hold per thread, and the graph they built keeps its
route after the context is left.
"""

from __future__ import annotations

import contextlib
import contextvars
import os

_FORCE_UNPACKED = contextvars.ContextVar("mgt_force_unpacked", default=False)

# The inputs of the fused Functions that a second-order scope can name.
INPUTS = frozenset(("x", "w", "styles", "noise", "bias", "resid"))

_SCOPE = contextvars.ContextVar("mgt_second_order_scope", default=None)


def packed_paths_disabled() -> bool:
    return _FORCE_UNPACKED.get()


@contextlib.contextmanager
def force_unpacked():
    token = _FORCE_UNPACKED.set(True)
    try:
        yield
    finally:
        _FORCE_UNPACKED.reset(token)


def in_second_order_scope() -> bool:
    """True inside `second_order_scope()` alone (the env's global form is
    not a scope): K4's gate reads this."""
    return _SCOPE.get() is not None


def scope_reaches():
    """What a fused Function's forward records: the names of the inputs
    whose cotangents its backward takes under create_graph (the scope's
    `reaches`; every input under MGT_PACKED_SECOND_ORDER=1, JAX's global
    form), or None outside the scope, where that backward raises."""
    reaches = _SCOPE.get()
    if reaches is None and os.environ.get("MGT_PACKED_SECOND_ORDER", "0") == "1":
        return INPUTS
    return reaches


def packed_second_order() -> bool:
    """True inside `second_order_scope()`, or everywhere with
    MGT_PACKED_SECOND_ORDER=1: the fused Functions built then are
    differentiable twice."""
    return scope_reaches() is not None


@contextlib.contextmanager
def second_order_scope(reaches=INPUTS):
    """The fused Functions built inside take the second-order route.
    `reaches` names the inputs (of "x", "w", "styles", "noise", "bias",
    "resid") that the caller's inner gradient reaches: a backward under
    create_graph forms only their cotangents, and raises if the gradient
    it runs for needs one left out. The flag is a context variable read
    while the forward runs, so the graph keeps its route after the context
    is left."""
    reaches = frozenset(reaches)
    if not reaches <= INPUTS:
        raise ValueError(f"unknown inputs {sorted(reaches - INPUTS)}; take {sorted(INPUTS)}")
    token = _SCOPE.set(reaches)
    try:
        yield
    finally:
        _SCOPE.reset(token)
