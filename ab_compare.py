#!/usr/bin/env python3
"""Compare two trees of the port on one card, in turns: run as BASE,
CHANGE, CHANGE, BASE, each turn a fresh process in its tree running that
tree's own `chip_smoke.py` phases.

    git archive <base commit> | tar -x -C _checkout/base   # a gitignored dir
    python3 ab_compare.py _checkout/base .            # steps, serving, eval
    python3 ab_compare.py --flash _checkout/base .    # kernels 2/3
    python3 ab_compare.py --fca _checkout/base .      # kernel 1

The default turn is the long-sequence train step, serving and the
Multi30K-scale eval.  `--flash` takes kernels 2/3 instead: `flash_phase`
(each path shape's forward and backward beside SDPA) and the profiled
flagship and large-batch train steps (their `single_flash_ms`, kernels 2
and 3's device ms in the step).  `--fca` takes kernel 1: `kernel_phase`
at the image model's shapes (Dh = 64) and the video model's (Dh = 512)
plus FEW_KEYS, each timed beside SDPA; on a tree with key splits, the
SPLIT_CALLS timed with `wide_split_plan`'s splits and with one split
(`wide_splits` lines); then the video eval's embed_images seconds:
configs/msrvtt.yaml's model (seeded weights) embedding VIDEO_EVAL_VIDEOS
synthetic videos in batches of its batch_size_test, as the eval does.

Each tree builds its own kernels (both at once) into its own
`leccr_torch/_build/`.  Every phase line the turns print goes to stdout
with a "side" and "turn" key; the last line is a summary: per side the
mean of its two turns' numbers (ms/step, device ms, busy share, eval s,
embed_images s; with --flash also each bf16 shape's kernel and SDPA ms and
the steps' single_flash_ms; with --fca each bf16 shape's kernel and SDPA
ms, the split calls' ms both ways and embed_images_s).  Compare two commits only inside one such
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
# kernel 1 at Dh = 512 timed beside the video path's shapes: 3-16 keys over
# many query rows, on no config's path; and (videos, Lq, Lk) of calls with
# a few videos (an index update), timed with the key splits that
# `wide_split_plan` gives and with one split
FEW_KEYS = ((32, 16), (145, 4))
SPLIT_CALLS = ((2, 2, 200), (2, 2, 32), (8, 2, 200), (8, 2, 32))
FCA_TURN = HEAD + f"FEW_KEYS, SPLIT_CALLS = {FEW_KEYS}, {SPLIT_CALLS}\n" + """
import math
import time
from leccr_torch.models.leccr import LECCRModel
from leccr_torch.ops.fused_cross_attention import fused_cross_attention
print(card, flush=True)
cs.kernel_phase(edges=())
cs.kernel_phase(dh=cs.VIDEO_DH, shapes=tuple(cs.VIDEO_SHAPES) + FEW_KEYS,
                edges=(), phase="video_kernel")
from leccr_torch.ops import fused_cross_attention as fca
if hasattr(fca, "wide_split_plan"):  # its key splits against one split
    flush = torch.empty(2 ** 30, dtype=torch.uint8, device="cuda").zero_
    plan = fca.wide_split_plan
    for videos, lq, lk in SPLIT_CALLS:
        g = torch.Generator(device="cuda").manual_seed(videos * lk + lq)
        q, k, v = (torch.randn(videos, n, 8, cs.VIDEO_DH, device="cuda",
                               generator=g).to(torch.bfloat16).transpose(1, 2)
                   for n in (lq, lk, lk))
        pad = torch.rand(videos, lk, device="cuda", generator=g) < 0.3
        want = fca.fused_cross_attention_reference(q, k, v, pad)
        row = {"videos": videos, "lq": lq, "lk": lk, "splits": fca.wide_splits(
            videos * 8, lq, lk, cs.VIDEO_DH, q.dtype, q.device)[0]}
        for name, use in (("plan", plan), ("one_split",
                                          lambda h, lq, lk, *a: (1, lk))):
            fca.wide_split_plan = use
            got = fca.fused_cross_attention(q, k, v, pad)
            if not cs.kernel1_within((got.float() - want.float()).abs(),
                                     want)[0]:
                raise AssertionError(f"{name} at {videos}x{lq}x{lk}")
            row[f"{name}_ms"] = cs.cuda_ms(
                lambda: fca.fused_cross_attention(q, k, v, pad), flush)
        fca.wide_split_plan = plan
        cs.emit("wide_splits", **row)
cfg = load_config(str(cs.ROOT / "configs" / "msrvtt.yaml"))
mcfg = cfg.model
model = LECCRModel(mcfg, device="cuda", seed=0)
g = torch.Generator(device="cuda").manual_seed(1)
n, frames, length = (cfg.train.batch_size_test, mcfg.vision.max_frames,
                     cfg.data.max_tokens)
batches = []
for _ in range(math.ceil(cs.VIDEO_EVAL_VIDEOS / n)):
    valid = torch.randint(2, frames + 1, (n, 1), device="cuda", generator=g)
    words = torch.randint(1, length + 1, (n, 1), device="cuda", generator=g)
    caption_mask = (torch.arange(length, device="cuda")[None] < words).int()
    batches.append({
        "vision": torch.randn((n, frames, mcfg.vision.frame_feat_dim),
                              device="cuda", generator=g),
        "vision_mask": torch.arange(frames, device="cuda")[None] < valid,
        "caption_ids": torch.randint(1, mcfg.text.vocab_size, (n, length),
                                     device="cuda", generator=g)
        * caption_mask,
        "caption_mask": caption_mask})
model.embed_images(batches[0])
cs.reset_counts()
torch.cuda.synchronize()
t0 = time.perf_counter()
for batch in batches:
    model.embed_images(batch)
torch.cuda.synchronize()
cs.emit("video_embed_images", embed_images_s=time.perf_counter() - t0,
        videos=len(batches) * n, batch=n,
        kernel1=dict(fused_cross_attention.launches_by_body))
"""
BUILD = ("import sys; sys.path.insert(0, '.'); "
         "from leccr_torch.ops import _build; _build.build({})")
LIBS = "'flash_tower_attention', 'flash_chunked_attention', " \
       "'fused_cross_attention'"
FLASH_LIBS = "'flash_tower_attention', 'fused_infonce'"
FCA_LIBS = "'fused_cross_attention', 'flash_tower_attention'"
KEYS = {"slice_train_step": ("ms_per_step",),
        "slice_train_step_profile": ("device_ms", "device_busy_share"),
        "eval": ("wall_s", "embed_images_s")}
FLASH_KEYS = {"train_step": ("ms_per_step",),
              "train_step_profile": ("device_ms", "single_flash_ms"),
              "large_batch_step": ("ms_per_step",),
              "large_batch_step_profile": ("device_ms", "single_flash_ms")}
FCA_KEYS = {"video_embed_images": ("embed_images_s",)}
MODES = {"default": (LIBS, TURN, KEYS), "flash": (FLASH_LIBS, FLASH_TURN,
                                                  FLASH_KEYS),
         "fca": (FCA_LIBS, FCA_TURN, FCA_KEYS)}


def summed(row: dict, keys) -> dict:
    """The numbers of `row` to average over a side's turns, by name: the
    KEYS of its phase; a flash_vs_plain, kernel_vs_plain or
    video_kernel_vs_plain line's bf16 kernel and SDPA ms."""
    phase = row.get("phase")
    if phase in ("flash_vs_plain", "kernel_vs_plain",
                 "video_kernel_vs_plain"):
        if row["dtype"] != "bfloat16":
            return {}
        shape = (f"{row['shape']}.{row['direction']}"
                 if phase == "flash_vs_plain" else f"{row['lq']}x{row['lk']}")
        name = f"{phase}.{shape}"
        return {f"{name}.ms": row["ms"], f"{name}.library_ms":
                row["library_ms"]}
    if phase == "wide_splits":
        name = f"{phase}.{row['videos']}x{row['lq']}x{row['lk']}"
        return {f"{name}.plan_ms": row["plan_ms"],
                f"{name}.one_split_ms": row["one_split_ms"]}
    out = {}
    for key in keys.get(phase, ()):
        value = row[key]
        if isinstance(value, dict):  # single_flash_ms: fwd and bwd
            out.update({f"{phase}.{key}.{k}": v for k, v in value.items()})
            out[f"{phase}.{key}.sum"] = sum(value.values())
        else:
            out[f"{phase}.{key}"] = value
    return out


def main(base: str, change: str, mode: str = "default") -> int:
    trees = {"base": Path(base).resolve(), "change": Path(change).resolve()}
    libs, turn_code, keys = MODES[mode]
    build = BUILD.format(libs)
    builds = [subprocess.Popen([sys.executable, "-c", build], cwd=tree)
              for tree in trees.values()]
    if any(b.wait() != 0 for b in builds):
        print("ab_compare: a build failed", file=sys.stderr)
        return 1
    sums = {side: {} for side in trees}
    for turn, side in enumerate(("base", "change", "change", "base")):
        run = subprocess.run([sys.executable, "-c", turn_code],
                             cwd=trees[side], capture_output=True, text=True)
        if run.returncode != 0:
            print(run.stderr[-4000:], file=sys.stderr)
            return 1
        for line in run.stdout.splitlines():
            if not line.startswith("{"):  # the card's line, among others
                print(json.dumps({"side": side, "turn": turn, "line": line}),
                      flush=True)
                continue
            row = json.loads(line)
            print(json.dumps({"side": side, "turn": turn, **row}), flush=True)
            for name, value in summed(row, keys).items():
                sums[side][name] = sums[side].get(name, 0.0) + value / 2
    print(json.dumps({"ab_summary": sums}), flush=True)
    return 0


if __name__ == "__main__":
    args = sys.argv[1:]
    modes = [m for m in MODES if f"--{m}" in args]
    args = [a for a in args if a[2:] not in MODES]
    if len(args) != 2 or len(modes) > 1:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(*args, mode=modes[0] if modes else "default"))
