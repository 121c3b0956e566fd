#!/usr/bin/env python3
"""Compare two trees of the port on one card, in turns: the long-sequence
train step, serving and the Multi30K-scale eval of each tree's own
`chip_smoke.py`, run as BASE, CHANGE, CHANGE, BASE.

    git archive <base commit> | tar -x -C _checkout/base   # a gitignored dir
    python3 ab_compare.py _checkout/base .

Each tree builds its own kernels (both at once) into its own
`leccr_torch/_build/`; each turn is a fresh process in that tree.  Every
phase line the turns print goes to stdout with a "side" and "turn" key;
the last line is a summary: per side the mean of its two turns' ms/step,
device ms and busy share of the step, eval wall s and embed_images s.
Compare two commits only inside one such call.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

TURN = """
import sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from leccr_torch.config import load_config
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
card = cs.card()
cs.train_step_phase(cs.slice_config(), card, cs.SLICE_STEP_LAUNCHES[True],
                    phase="slice_train_step", batch=32)
cfg = load_config(str(cs.ROOT / "configs" / "multi30k_all.yaml"))
emb, _ = cs.serve_phase(cfg)
cs.eval_phase(emb, card)
"""
BUILD = ("import sys; sys.path.insert(0, '.'); "
         "from leccr_torch.ops import _build; "
         "_build.build('flash_tower_attention', 'flash_chunked_attention', "
         "'fused_cross_attention')")
KEYS = {"slice_train_step": ("ms_per_step",),
        "slice_train_step_profile": ("device_ms", "device_busy_share"),
        "eval": ("wall_s", "embed_images_s")}


def main(base: str, change: str) -> int:
    trees = {"base": Path(base).resolve(), "change": Path(change).resolve()}
    builds = [subprocess.Popen([sys.executable, "-c", BUILD], cwd=tree)
              for tree in trees.values()]
    if any(b.wait() != 0 for b in builds):
        print("ab_compare: a build failed", file=sys.stderr)
        return 1
    sums = {side: {} for side in trees}
    for turn, side in enumerate(("base", "change", "change", "base")):
        run = subprocess.run([sys.executable, "-c", TURN], cwd=trees[side],
                             capture_output=True, text=True)
        if run.returncode != 0:
            print(run.stderr[-4000:], file=sys.stderr)
            return 1
        for line in run.stdout.splitlines():
            if not line.startswith("{"):
                continue
            row = json.loads(line)
            print(json.dumps({"side": side, "turn": turn, **row}), flush=True)
            for key in KEYS.get(row.get("phase"), ()):
                name = f"{row['phase']}.{key}"
                sums[side][name] = sums[side].get(name, 0.0) + row[key] / 2
    print(json.dumps({"ab_summary": sums}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1], sys.argv[2]))
