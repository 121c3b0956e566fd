#!/usr/bin/env python3
"""Compare two trees of the port on one card, in turns: run as BASE,
CHANGE, CHANGE, BASE, each turn a fresh process in its tree running that
tree's own `chip_smoke.py` phases.

    git archive <base commit> | tar -x -C _checkout/base   # a gitignored dir
    python3 ab_compare.py _checkout/base .            # steps, serving, eval
    python3 ab_compare.py --flash _checkout/base .    # kernels 2/3

The default turn is the long-sequence train step, serving and the
Multi30K-scale eval.  `--flash` takes kernels 2/3 instead: `flash_phase`
(each path shape's forward and backward beside SDPA) and the profiled
flagship and large-batch train steps (their `single_flash_ms`, kernels 2
and 3's device ms in the step).

Each tree builds its own kernels (both at once) into its own
`leccr_torch/_build/`.  Every phase line the turns print goes to stdout
with a "side" and "turn" key; the last line is a summary: per side the
mean of its two turns' numbers (ms/step, device ms, busy share, eval s,
embed_images s; with --flash also each bf16 shape's kernel and SDPA ms and
the steps' single_flash_ms).  Compare two commits only inside one such
call.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

HEAD = """
import sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from leccr_torch.config import load_config
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
card = cs.card()
"""
TURN = HEAD + """
cs.train_step_phase(cs.slice_config(), card, cs.SLICE_STEP_LAUNCHES[True],
                    phase="slice_train_step", batch=32)
cfg = load_config(str(cs.ROOT / "configs" / "multi30k_all.yaml"))
emb, _ = cs.serve_phase(cfg)
cs.eval_phase(emb, card)
"""
FLASH_TURN = HEAD + """
print(card, flush=True)
cs.flash_phase()
cfg = load_config(str(cs.ROOT / "configs" / "multi30k_all.yaml"))
cs.train_step_phase(cfg, card, cs.FLAGSHIP_STEP_LAUNCHES)
cs.train_step_phase(cs.large_batch_config(), card, cs.LARGE_STEP_LAUNCHES,
                    phase="large_batch_step", batch=cs.LARGE_BATCH,
                    warmup=1, steps=2)
"""
BUILD = ("import sys; sys.path.insert(0, '.'); "
         "from leccr_torch.ops import _build; _build.build({})")
LIBS = "'flash_tower_attention', 'flash_chunked_attention', " \
       "'fused_cross_attention'"
FLASH_LIBS = "'flash_tower_attention', 'fused_infonce'"
KEYS = {"slice_train_step": ("ms_per_step",),
        "slice_train_step_profile": ("device_ms", "device_busy_share"),
        "eval": ("wall_s", "embed_images_s")}
FLASH_KEYS = {"train_step": ("ms_per_step",),
              "train_step_profile": ("device_ms", "single_flash_ms"),
              "large_batch_step": ("ms_per_step",),
              "large_batch_step_profile": ("device_ms", "single_flash_ms")}


def summed(row: dict, keys) -> dict:
    """The numbers of `row` to average over a side's turns, by name: the
    KEYS of its phase; a flash_vs_plain line's bf16 kernel and SDPA ms."""
    phase = row.get("phase")
    if phase == "flash_vs_plain":
        if row["dtype"] != "bfloat16":
            return {}
        name = f"{phase}.{row['shape']}.{row['direction']}"
        return {f"{name}.ms": row["ms"], f"{name}.library_ms":
                row["library_ms"]}
    out = {}
    for key in keys.get(phase, ()):
        value = row[key]
        if isinstance(value, dict):  # single_flash_ms: fwd and bwd
            out.update({f"{phase}.{key}.{k}": v for k, v in value.items()})
            out[f"{phase}.{key}.sum"] = sum(value.values())
        else:
            out[f"{phase}.{key}"] = value
    return out


def main(base: str, change: str, flash: bool = False) -> int:
    trees = {"base": Path(base).resolve(), "change": Path(change).resolve()}
    build = BUILD.format(FLASH_LIBS if flash else LIBS)
    builds = [subprocess.Popen([sys.executable, "-c", build], cwd=tree)
              for tree in trees.values()]
    if any(b.wait() != 0 for b in builds):
        print("ab_compare: a build failed", file=sys.stderr)
        return 1
    turn_code, keys = (FLASH_TURN, FLASH_KEYS) if flash else (TURN, KEYS)
    sums = {side: {} for side in trees}
    for turn, side in enumerate(("base", "change", "change", "base")):
        run = subprocess.run([sys.executable, "-c", turn_code],
                             cwd=trees[side], capture_output=True, text=True)
        if run.returncode != 0:
            print(run.stderr[-4000:], file=sys.stderr)
            return 1
        for line in run.stdout.splitlines():
            if not line.startswith("{"):
                continue
            row = json.loads(line)
            print(json.dumps({"side": side, "turn": turn, **row}), flush=True)
            for name, value in summed(row, keys).items():
                sums[side][name] = sums[side].get(name, 0.0) + value / 2
    print(json.dumps({"ab_summary": sums}), flush=True)
    return 0


if __name__ == "__main__":
    args = sys.argv[1:]
    flash = "--flash" in args
    args = [a for a in args if a != "--flash"]
    if len(args) != 2:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(*args, flash=flash))
