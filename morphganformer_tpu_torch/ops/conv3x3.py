"""K4: the plain SAME 3x3 convolution of the unpacked high-resolution blocks.

Port of `_conv3x3_kernel`, `conv3x3_same_pallas`, `conv3x3_same` with its
custom VJP and `pallas_conv_eligible` (morphganformer_tpu/ops/pallas_conv.py
:74-111, :322-387, :1016-1035). JAX sends a plain SAME 3x3 stride-1 conv to
K4 when MGT_PALLAS_CONV=1 and the shape passes the eligibility rule
(conv2d_resample.py:236-251); the port's `conv2d_resample` does the same.
At FFHQ-1024 widths these are the `skip` and `orig` layouts' G b512 conv1,
b1024 conv1 and b1024 conv_last (on x * s: the unfused modulated conv
scales x before the conv) and D b1024 and b512 conv0.

`Conv3x3Same` is the autograd Function. On a CUDA tensor its forward is
the kernel `mgt_conv3x3_fwd` (csrc/fused_conv.cu: K1's least-work forward
with no scale slot, no demodulation and no epilogue) and its dx
`mgt_conv3x3_dx`, K1's adjoint launch on the cotangent with no mask, scale
or taps, which reads flip(w)^T from w by index, as JAX's VJP reuses K4.
Both sum in cuDNN's order, so the route gives the F.conv2d path's results
to the bit; like K1, they take channel counts in fours, and float32 alone:
a bfloat16 operand raises on either device, never runs on cuDNN (K4's
bfloat16 role is not ported). Its dw is nine tap
sums, one matrix product per tap: JAX forms them with an XLA einsum outside
any Pallas kernel, so there is no TPU kernel to port, and the products take
any C and O without the padding that `mgt_conv_dw` needs. On a CPU tensor
the forward and dx take the plain version. Only the cotangents that
`ctx.needs_input_grad` asks for are formed, and the backward is
once-differentiable (`first_order_only`: it raises under create_graph=True):
K4 has no second-order route, in JAX or here, so both routes that take a
second derivative keep it off, the unpacked one (ops/packed_override.py)
and `second_order_scope()` (the same module).

The TPU lane packing of `conv3x3_same_packed` (a reshape that fills
128-lane MXU tiles, the same function) is not carried over. The kernel
launches are counted in `fused_conv.launch_counts` under "conv3x3"
(forward) and "conv3x3_adj" (dx).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from morphganformer_tpu_torch.ops.fused_conv import (
    _aligned,
    _check,
    _launch,
    _on_cpu,
    _stream,
    first_order_only,
    k1_widths,
    launch_counts,
    lw_widths_ok,
)
from morphganformer_tpu_torch.ops.packed_override import (
    in_second_order_scope,
    packed_paths_disabled,
)


def conv3x3_same_plain(x, w):
    """SAME-padded stride-1 3x3 correlation. x [N,H,W,C]; w [3,3,C,O] -> [N,H,W,O]."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1)
    return y.permute(0, 2, 3, 1)


def conv3x3_adjoint_weights(w):
    """flip(w)^T [3,3,O,C]: dx = conv3x3_same(g, flip(w)^T) (pallas_conv.py:366-370)."""
    return w.flip((0, 1)).transpose(2, 3).contiguous()


def conv3x3_dw(x, g):
    """dw[dy,dx,c,o] = sum_{n,y,x} xpad[n, y+dy, x+dx, c] * g[n, y, x, o]
    (pallas_conv.py:371-385), one matrix product per tap."""
    n, h, wd, c = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    g2 = g.reshape(-1, g.shape[-1])
    return torch.stack([torch.stack([xp[:, dy:dy + h, dx:dx + wd].reshape(-1, c).T @ g2
                                     for dx in range(3)]) for dy in range(3)])


def _on_card(x):
    return x.is_cuda


def conv3x3_eligible(x, w, groups) -> bool:
    """JAX's rule (`pallas_conv_eligible`): groups 1, a 3x3 kernel, square
    input of side >= 512, C <= 64, O <= 64, even width; the tensor on a card
    in place of the TPU backend; never under `force_unpacked()`. And what
    the kernel takes: C and O in fours (the rest runs on cuDNN, as JAX's
    ineligible convs run on XLA). Never inside `second_order_scope()`
    either, where JAX's gate would admit K4 and its second derivative
    would then fail."""
    if packed_paths_disabled() or in_second_order_scope() or not _on_card(x) or groups != 1:
        return False
    kh, kw, _, co = w.shape
    _, h, wd, c = x.shape
    return (kh, kw) == (3, 3) and h == wd and h >= 512 and c <= 64 and co <= 64 \
        and wd % 2 == 0 and lw_widths_ok(c, co)


def _conv3x3(t, w, key):
    """One K4 launch, counted under `key`: the forward conv3x3_same(t, w)
    ("conv3x3", `mgt_conv3x3_fwd`), or the dx of the cotangent t,
    conv3x3_same(t, flip(w)^T) ("conv3x3_adj", `mgt_conv3x3_dx`); the plain
    version for a CPU tensor."""
    t, w = t.contiguous(), w.contiguous()
    dx = key == "conv3x3_adj"
    if t.dtype == torch.bfloat16:
        raise NotImplementedError(
            "K4 (mgt_conv3x3_fwd and its dx, the MGT_PALLAS_CONV=1 route of the skip/orig "
            "layouts) takes float32 only: its bfloat16 role is not ported (ROADMAP.md queue "
            "2A); unset MGT_PALLAS_CONV to run these layouts in bfloat16")
    if _on_cpu(t):
        return conv3x3_same_plain(t, conv3x3_adjoint_weights(w) if dx else w)
    n, h, wd, _ = t.shape
    c, o = w.shape[2], w.shape[3]
    dev = t.device
    k1_widths(c, o)
    ptrs = [_aligned("t", _check("t", t, (n, h, wd, o if dx else c), dev)),
            _aligned("w", _check("w", w, (3, 3, c, o), dev))]
    out = torch.empty((n, h, wd, c if dx else o), device=dev, dtype=torch.float32)
    _launch("mgt_conv3x3_dx" if dx else "mgt_conv3x3_fwd", *ptrs, out.data_ptr(), n, h, wd, c,
            o, *_stream(dev))
    launch_counts[key] += 1
    return out


def conv3x3_forward(x, w):
    """K4 forward: the kernel on a CUDA tensor, the plain version on a CPU one."""
    return _conv3x3(x, w, "conv3x3")


def conv3x3_dx(g, w):
    """K4's dx: the kernel on g, reading flip(w)^T from w by index."""
    return _conv3x3(g, w, "conv3x3_adj")


class Conv3x3Same(torch.autograd.Function):
    """K4 with its dx launch and the dw tap sums, each only when asked for."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return conv3x3_forward(x, w)

    @staticmethod
    @first_order_only
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        need_dx, need_dw = ctx.needs_input_grad
        return (conv3x3_dx(g, w) if need_dx else None,
                conv3x3_dw(x, g) if need_dw else None)


def conv3x3_same(x, w):
    """SAME-padded stride-1 3x3 correlation x [N,H,W,C] * w [3,3,C,O] on K4,
    differentiable once in x and w (`Conv3x3Same`)."""
    return Conv3x3Same.apply(x, w)
