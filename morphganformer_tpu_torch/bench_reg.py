"""The reg stages (G_reg: path length, D_reg: R1) on one card, on the routes
of this tree and on an earlier tree, in turns.

    mkdir -p build/parent
    git archive <commit> | tar -x -C build/parent
    python -m morphganformer_tpu_torch.bench_reg build/parent

Each turn is a process of its own, started from the root of its tree: the
earlier tree (whose reg stages run unpacked); this tree on its default
scoped route ("scoped": each stage's inner pass narrowed to the inputs it
reaches, `training/loss.py` PL_REACHES and R1_REACHES); the same with every
input named ("full": the inner passes also form the dw taps and the bias
and noise cotangents, which nothing reads); and this tree under
MGT_PACKED_SECOND_ORDER=0 (the unpacked route). The order is earlier,
scoped, full, unpacked, then the same backwards. A turn builds the
GANTrainer of FFHQ-1024 (`ffhq1024_config()`) and a 1024^2 D
(`DiscriminatorConfig()`), resnet, from seed 0, batch 4 in one round (path
length at batch 2), and times `g_reg_grads` and `d_reg_grads` with the
host clock around a synchronised call: one warm-up call, whose kernel
launches it counts, then `--reps` calls each; peak memory of each stage.
The worker uses only names that both trees have, the "full" route's apart.
Prints one JSON line per turn, then the card and the medians of each tree
and route; with no earlier tree, this tree's routes alone. Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

WORKER = r"""
import json, sys, time
import torch
from morphganformer_tpu_torch.models.config import DiscriminatorConfig, ffhq1024_config
from morphganformer_tpu_torch.training import GANTrainer, TrainConfig

reps, route = int(sys.argv[1]), sys.argv[2]
if route == "full":
    from morphganformer_tpu_torch.ops.packed_override import INPUTS
    from morphganformer_tpu_torch.training import loss as tloss
    tloss.PL_REACHES = tloss.R1_REACHES = INPUTS
from morphganformer_tpu_torch.ops import fused_conv as fc
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
trainer = GANTrainer(ffhq1024_config(), DiscriminatorConfig(),
                     TrainConfig(batch_size=4, batch_gpu=4), device="cuda")
state = trainer.init_state(seed=0)
gen = torch.Generator(device="cuda").manual_seed(4)
reals = torch.rand((1, 4, 1024, 1024, 3), generator=gen, device="cuda") * 2 - 1
z = torch.randn((1, 4, trainer.g_cfg.k, trainer.g_cfg.z_dim), generator=gen, device="cuda")
out = {}
for stage, call in (("g_reg", lambda: trainer.g_reg_grads(state, z)),
                    ("d_reg", lambda: trainer.d_reg_grads(state, reals))):
    fc.reset_launch_counts()
    call()
    torch.cuda.synchronize()
    launches = {k: v for k, v in fc.launch_counts.items() if v}
    torch.cuda.reset_peak_memory_stats()
    secs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    out[stage] = dict(s=secs, peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                      launches=launches)
print("RESULT " + json.dumps(out), flush=True)
"""


def run_turn(tree, route, reps):
    """One turn in a fresh process from the root of `tree`; `route` "scoped"
    or "full" (MGT_PACKED_SECOND_ORDER unset) or "unpacked" ("0")."""
    env = dict(os.environ)
    env.pop("MGT_PACKED_SECOND_ORDER", None)
    if route == "unpacked":
        env["MGT_PACKED_SECOND_ORDER"] = "0"
    env["PYTHONPATH"] = str(tree)
    proc = subprocess.run([sys.executable, "-c", WORKER, str(reps), route], cwd=tree, env=env,
                          capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"turn {tree} {route} failed:\n{proc.stdout[-4000:]}"
                           f"\n{proc.stderr[-4000:]}")
    line = next(ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent", nargs="?", help="root of an earlier tree (its reg stages unpacked)")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    turns = [(REPO, "scoped"), (REPO, "full"), (REPO, "unpacked")]
    if args.parent:
        parent = Path(args.parent).resolve()
        turns = [(parent, "earlier")] + turns + turns[::-1] + [(parent, "earlier")]
    else:
        turns = turns + turns[::-1]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    runs = {}
    for tree, route in turns:
        res = run_turn(tree, "unpacked" if route == "earlier" else route, args.reps)
        print(json.dumps({"route": route, **res}), flush=True)
        for stage, r in res.items():
            runs.setdefault((route, stage), []).extend(r["s"])
            runs.setdefault((route, stage, "peak"), []).append(r["peak_gib"])
    print(card, flush=True)
    summary = {f"{route} {stage}": dict(median_s=statistics.median(secs), min_s=min(secs),
                                        max_s=max(secs), calls=len(secs),
                                        peak_gib=max(runs[(route, stage, "peak")]))
               for (route, stage, *rest), secs in runs.items() if not rest}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
