"""Module summaries: each module's output shape and parameter count (port of
morphganformer_tpu/utils/summary.py).

The reference prints a summary of G and D at the start of training
(torch_utils/misc.py:169-244 `print_module_summary`, called at
training_loop.py:135-141); it doubles as a check of the nets' shapes. As
there, one forward at batch 1 runs with hooks on every module down to
DEPTH: a pre-hook records the order in which modules are entered, a
forward hook the shapes of what each returns. A module called twice gets
two rows.
"""

from __future__ import annotations

import torch


def _shapes(out):
    if isinstance(out, torch.Tensor):
        return [list(out.shape)]
    if isinstance(out, (tuple, list)):
        return [s for o in out for s in _shapes(o)]
    return []


DEPTH = 2      # rows for the net, its children and theirs


def module_summary(model: torch.nn.Module, title: str, *args, **kwargs) -> str:
    """One forward of `model(*args, **kwargs)` without a graph, as a table
    of module name, class, output shapes and parameters (its own and its
    children's) down to DEPTH."""
    rows, hooks, open_rows = [], [], {}
    for name, mod in model.named_modules():
        level = 0 if not name else name.count(".") + 1
        if level > DEPTH:
            continue

        def pre(m, inp, label=("  " * level) + (name or title)):
            open_rows.setdefault(id(m), []).append(len(rows))
            rows.append([label, type(m).__name__, None, sum(p.numel() for p in m.parameters())])

        def post(m, inp, out):
            rows[open_rows[id(m)].pop()][2] = _shapes(out)

        hooks += [mod.register_forward_pre_hook(pre), mod.register_forward_hook(post)]
    try:
        with torch.no_grad():
            model(*args, **kwargs)
    finally:
        for h in hooks:
            h.remove()
    table = [("Module", "Class", "Outputs", "Parameters")]
    table += [(n, c, " ".join("x".join(map(str, s)) for s in (o or [])) or "-", f"{p:,}")
              for n, c, o, p in rows]
    widths = [max(len(r[i]) for r in table) for i in range(4)]
    lines = [f"{title} summary"]
    for i, r in enumerate(table):
        lines.append("  ".join(r[j].ljust(widths[j]) for j in range(3)) + "  "
                     + r[3].rjust(widths[3]))
        if i == 0:
            lines.append("-" * (sum(widths) + 6))
    total = sum(p.numel() for p in model.parameters())
    buffers = sum(b.numel() for b in model.buffers())
    lines.append(f"Total: {total:,} parameters, {buffers:,} buffer elements")
    return "\n".join(lines) + "\n"


def generator_summary(G, batch: int = 1) -> str:
    cfg = G.cfg
    dev = next(G.parameters()).device
    z = torch.zeros((batch, cfg.k, cfg.z_dim), device=dev)
    return module_summary(G, "G", z=z, noise_mode="const")


def discriminator_summary(D, batch: int = 1) -> str:
    cfg = D.cfg
    dev = next(D.parameters()).device
    img = torch.zeros((batch, cfg.img_resolution, cfg.img_resolution, cfg.img_channels),
                      device=dev)
    return module_summary(D, "D", img)
