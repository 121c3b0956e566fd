#!/usr/bin/env python3
"""Drive the PyTorch port (`leccr_torch`) on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, each printing one JSON line (any failure raises: exit code 1):

1. device + build: the card's name and power limit (nvidia-smi), then the
   CUDA kernels built from `leccr_torch/csrc/` with nvcc, one process per
   source, side by side (seconds, ptxas report; the wgmma kernels of 4-8,
   both files' wrappers, and the InfoNCE kernels 9-11 with their merge
   passes must show 0 spill bytes).
2. kernel 1 vs plain: the fused cross-attention kernel against its plain
   PyTorch version at the three embed_images shapes (B=64, H=8, Dh=64;
   (Lq, Lk) = (4,200), (145,4), (4,145)) in bf16 and f32, with random key
   padding and one fully padded row, each on the body `fused_body` picks
   (few queries, few keys: the per-body counters), and checked only at the
   edge shapes (1,200), (145,1), (145,16), (145,17) (the general body).
   Tolerance: f32 max abs err <= 1e-5;
   bf16 every element within 1e-5 plus 1 bf16 ulp of the plain result
   (both round an f32 result to bf16 once, so f32 noise can move it one
   ulp).  Times the kernel, the plain version and
   F.scaled_dot_product_attention (a yardstick only; the port never calls
   it) with the L2 cache flushed before each launch, and computes the least
   time the card could take (bytes at 3.35 TB/s vs flops at the dtype's
   peak).
3. kernels 2/3 vs plain: the flash tower-attention forward and backward
   against their plain versions at the train steps' shapes (flagship:
   vision [128,12,145,64] at rate 0; text [256,12,64,64] and caption
   [128,12,64,64], forward only; long-sequence slice: text [64,16,64,64]
   and caption [32,16,64,64], forward only; texts and captions with key
   padding, one fully padded row and dropout 0.1), bf16 and f32, and the
   text shape in bf16 with unaligned rows: out, lse, dq, dk, dv.  Every
   bf16 path shape must take the tensor-core variant, f32 and the
   unaligned shape the scalar one (`single_block_variant`, and the
   tensor-core launch counters).  Tolerance: f32
   out and lse atol 1e-5, grads 1e-4; bf16 lse 1e-5 and every other
   element within 1e-5 + BF16_K bf16 ulps of the sum of the absolute
   values of its terms (see flash_term_scales).  Timed like phase 2, with
   SDPA at rate 0 (forward, and the backward alone of a saved forward) as
   the yardstick.  Then the dropout masks that the forward and the
   backward's two passes apply, read back bit for bit at the text shape
   (`single_masks`), must equal keep_mask.
4. kernels 4/5 vs plain: the chunked flash forward and backward against
   their plain versions at ViT-L/14 @336's [32,16,577,64] (rate 0, no
   padding) and a 200-token text batch [64,16,200,64] (key padding, a
   fully padded row: out 0, lse -inf, zero gradients; dropout 0.1), bf16
   and f32, with phase 3's tolerances (the term sums under the chunked
   rules) and timing.  Every bf16 forward and backward must run kernels 4
   and 5's wgmma variant, f32 the scalar one (`tiled_variant` and the wgmma
   launch counters), and with dropout kernel 4's mask, read back bit for
   bit on that variant, must equal the plain hash at head group 2.  Then
   ragged lengths 1, 63, 64, 65, 129 at 16 heads (head group 2) and 3
   (head group 1) in bf16 with padding and dropout 0.1 (CHUNKED_RAGGED),
   kernel 5's dq-pass and dk/dv-pass masks read back bit for bit.
4b. kernels 6/7/8 vs plain (`tiled_phase`): the tiled flash forward, dq
   and dk/dv kernels against their plain versions at TILED_SHAPES: the
   high-resolution step's ViT-L/14 @728 as the step calls them,
   [8,16,2705,64] bf16 at rate 0, the same at batch 2 with dropout 0.1,
   and with key padding and a fully padded row, [2,16,1601,64]
   f32 (ViT-L/14 @560, tiled in f32 only) and [2,12,2705,64] bf16 (head
   group 6), with phase 4's tolerances (the term sums under the tiled head
   group; delta within 1e-5 of max(1, |delta|) of rowsum(g·out) from the
   kernel's own output); the dropout masks each
   kernel applies, read back bit for bit (`tiled_masks`), equal the plain
   hash.  Every bf16 shape must run kernels 6-8 on their wgmma variant
   (`tiled_variant` and the wgmma launch counters, the mask read-backs
   included), f32 on the scalar one.  Each kernel timed per launch at
   [8,16,2705,64] bf16 beside its bound, its plain version, SDPA (forward;
   the backward alone for 7 + 8 together, on kernel 7's row) and the
   chunked kernels 4/5 forced onto the same shape (the same wgmma bodies
   at head group 2); kernels 7 and 8 also on both grids of their passes,
   one block per item and persistent, in turns (`schedules_ms`).
5. kernels 9-11 vs plain: the fused InfoNCE statistics, dq and dk
   kernels against their plain versions at E = 256, inv_temp 1/0.07, at
   INFONCE_SHAPES: the large-batch step's [4096] x [4096] (idx = arange),
   the same with every id twice, a ragged [1000] x [1000], a ring block
   [256] x [32768] (q's ids a subset of k's, some rows without a positive)
   and [32768] x [32768]; untimed, [33] x [4097] with every id twice (a
   ragged last tile, a last split of one column).  Tolerance: lse and
   pos_sum within 1e-5 of max(1, |x|), pos_cnt exact, dq_raw and dk_raw
   within 1e-4 of their largest element; two calls of each kernel
   bit-identical at [4096] x [4096].  Timed beside the bound (flops at 67
   TFLOP/s f32), the plain versions and the dense composition the port
   does not call (no single PyTorch call computes them), with the split
   grid each launched (`split_plan`: splits, blocks), TFLOP/s and ms /
   bound.  Then the whole loss (compute_losses
   forward + backward on 4096 random embeddings at the flagship's widths):
   fused + streaming against dense gather, time and peak memory, the 10
   keys within 1e-4 of max(1, |x|).
6. model check: the full-width model in f32 with kernel 1 vs with the
   plain attention path, on 4 images (atol 1e-4).
7. train gradient checks, full width in f32, dropouts 0, at 64 tokens:
   every parameter's gradient within 1e-3 of the reference's, relative to
   max(its largest |g|, 1e-4 · the model's largest |g|); each step
   launches exactly the kernels it should (FLAGSHIP_STEP_LAUNCHES,
   SLICE_STEP_LAUNCHES, LARGE_CHECK_LAUNCHES).  (a) The flagship through
   kernels 2/3 against the plain attention (4 examples), with the plain
   path in f64 beside it.  (b) The long-sequence slice (configs/
   scale_vitl_32k.yaml's ViT-L/14 @336 + XLM-R-large) through kernels 2-5
   with remat off and on; remat on and off agree within 1e-6.  (b') The
   high-resolution slice (the same at 728², 2705 vision tokens, 2
   examples) through kernels 2, 3 and 6-8 with remat off and on against
   the plain attention (recomputed per block, to hold one layer's scores
   at a time), remat on = off within 1e-6 (HIRES_STEP_LAUNCHES).  (c) The
   large-batch path: GradCache (4 microbatches) + fused InfoNCE + 8-row
   streaming against the monolithic dense step, 16 examples, both through
   kernels 2/3; the 10 loss keys within 1e-5 of max(1, |x|).
8. train steps: (a) the flagship step (bench.py:279-370's shapes: bs128,
   uint8 images at 384², random flips, texts and captions at 64 tokens,
   bf16 compute on f32 master weights, dropout as configured, AdamW with
   linear_warmup_decay(1e-5, 10000, 0)): exactly 36 forward and 24
   backward launches of kernels 2/3 a step and none of kernels 4/5 or
   9-11; (b) the long-sequence slice at bs32 (slice_config: flash in both
   towers, one card, remat): 48 launches of kernel 4 and 24 of kernel 5,
   72 of kernel 2 and 24 of kernel 3 a step.  Each: 3 warm-up and 5 timed
   steps; finite losses, every parameter moved; in bf16 every launch of
   kernels 2/3 on the tensor-core variant and every launch of kernels 4-8
   on the wgmma variant; ms/step, pairs/s, peak
   memory; then one step under torch.profiler (device time by kernel,
   busy share, kernels 2 and 3 alone).  (c) The slice step again with
   remat off (2 warm-up and 3 timed steps, then a profiled one): what
   remat costs.  (c') The
   high-resolution step (hires_config: the slice at 728², bs8, remat; 2
   warm-up and 3 timed steps, then a profiled one with kernels 6-8's share
   of device time): 48, 24 and 24 launches of kernels 6, 7 and 8 and the
   slice's 72/24 of kernels 2/3 a step, none of 4/5, and every launch of
   6-8 on the wgmma variant.  (d) The
   large-batch step (large_batch_config: the flagship at bs4096 in 16
   GradCache microbatches, fused negatives, 256-row streaming losses): 1
   warm-up and 2 timed steps, then a profiled one; 1152 and 384 launches
   of kernels 2/3 and 6 of each of kernels 9, 10 and 11 a step.
9. serving: `Embedder` at the flagship widths of configs/multi30k_all.yaml
   (ViT-B/32 @384², mBERT-base, 3/2/2 caption-interaction layers, bf16)
   with seeded random weights indexes 256 synthetic images with captions at
   200 tokens and answers search_texts (none, minmax) and search_images
   requests; kernel 1's launch count must be 7 per image batch, on its
   few-queries and few-keys bodies only.
10. eval: Multi30K scale (1 000 images × 5 000 texts at 200 tokens, image
   batch 50, text batch 256): embed + streaming ranks + Recall@K; the ranks
   must equal a dense count over the same block products; kernel 1 on its
   few-queries and few-keys bodies only; wall time and pairs/s.
11. fit: `Trainer(cfg).fit()` on configs/multi30k_all.yaml at full width
   from synthetic files on disk (FIT_OPTIONS: 64 images x 5 captions, 2
   steps an epoch at bs128, 2 epochs, 64 eval images, val + test, a
   mid-epoch snapshot): kernels 2/3 FLAGSHIP_STEP_LAUNCHES a step, all on
   the tensor-core variant, kernel 1 7 launches an embed_images batch on
   its small bodies; finite losses every step and finite sumR; log.txt
   and best.json; the last checkpoint restored into a second
   Trainer(resume) bit for bit.  Host-fed ms/step, the loader's wait,
   eval s per split (uncached, cached), checkpoint s and bytes.

Each path is driven with every launch count set to 0 just before it and
read just after.  Then one {"kernels": [...]} line and, last,
{"ok": true, "device": ...}.
TF32 is off for matmuls and cuDNN alike: every f32 product is full f32.
Without a CUDA device it exits 1 and prints no result.
"""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SHAPES = [(4, 200), (145, 4), (4, 145)]  # (Lq, Lk) of the interaction stacks
PATH_LAUNCHES = {(4, 200): 3, (145, 4): 2, (4, 145): 2}  # per embed_images
# kernel 1's edge shapes, checked (not timed) on each body: one query, one
# key, the few-keys body's last Lk and the first past it
EDGE_SHAPES = [(1, 200), (145, 1), (145, 16), (145, 17)]
# (name, B, H, L, dropout rate, key padding, backward) of the towers'
# calls of kernels 2/3 in one train step: in the flagship's (bs128) the ViT
# at 145 tokens, the text tower on source + target texts at the 64-token
# bucket, and again on the captions (forward only: they get no gradient);
# in the long-sequence slice's (bs32, 16 heads) the text tower likewise
FLASH_SHAPES = [("vision", 128, 12, 145, 0.0, False, True),
                ("text", 256, 12, 64, 0.1, True, True),
                ("caption", 128, 12, 64, 0.1, True, False),
                ("slice-text", 64, 16, 64, 0.1, True, True),
                ("slice-caption", 32, 16, 64, 0.1, True, False)]
# the text shape again in bf16, its rows 2 bytes off 16-byte alignment: the
# scalar variant of kernels 2/3, which f32, other head dims and unaligned
# views take, checked and timed beside the tensor-core one
SCALAR_FLASH_SHAPE = ("text-unaligned", 256, 12, 64, 0.1, True, True)
# (name, B, H, L, dropout rate, key padding) of kernels 4/5's checks: the
# ViT-L/14 @336 tower of the long-sequence slice's bs32 step, and a text
# batch at the 200-token bucket (past fits_vmem at 16 heads)
CHUNKED_SHAPES = [("vit-l", 32, 16, 577, 0.0, False),
                  ("text200", 64, 16, 200, 0.1, True)]
# kernels 4/5's ragged edges in bf16 (batch 2, key padding with a fully
# padded row, dropout 0.1): lengths around the 64-row tiles and 128-row
# items, at 16 heads (dropout head group 2) and 3 (head group 1); kernel 5's
# dropout masks are read back at each
CHUNKED_RAGGED = [(length, heads) for heads in (16, 3)
                  for length in (1, 63, 64, 65, 129)]
# (name, B, H, L, dtype, dropout rate, key padding) of kernels 6-8's
# checks: the high-resolution step's ViT-L/14 @728 (2705 tokens, past
# fits_chunked in bf16) exactly as the step calls them (bs8, no dropout: the
# CLIP tower has none), the same at batch 2 with dropout, and with key
# padding and a fully padded row, ViT-L/14 @560 in f32 (1601 tokens: tiled
# in f32 only) and 12 heads (head group 6; the chunked group is 2)
HIRES_RES = 728
HIRES_TOKENS = (HIRES_RES // 14) ** 2 + 1  # 52 x 52 patches + CLS = 2705
HIRES_BATCH = 8
TILED_SHAPES = [("vit-l@728-step", HIRES_BATCH, 16, HIRES_TOKENS, "bfloat16",
                 0.0, False),
                ("vit-l@728", 2, 16, HIRES_TOKENS, "bfloat16", 0.1, False),
                ("vit-l@728-padded", 2, 16, HIRES_TOKENS, "bfloat16", 0.1,
                 True),
                ("vit-l@560-f32", 2, 16, 1601, "float32", 0.0, False),
                ("h12", 2, 12, HIRES_TOKENS, "bfloat16", 0.1, False)]
TILED_TIMED = (HIRES_BATCH, 16, HIRES_TOKENS)  # bf16, rate 0: the step's ViT
FLASH_ITERS = 20
BF16_K = 2
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
KERNEL_LIBS = ("fused_cross_attention", "flash_tower_attention",
               "flash_chunked_attention", "flash_tiled_attention",
               "fused_infonce")
COUNTERS = ("fwd_launches", "bwd_launches", "chunk_fwd_launches",
            "chunk_bwd_launches", "tiled_fwd_launches", "tiled_dq_launches",
            "tiled_dkv_launches")  # kernels 2, 3, 4, 5, 6, 7, 8
INFONCE_COUNTERS = ("stats_launches", "dq_launches",
                    "dk_launches")  # kernels 9, 10, 11
STEP_COUNTERS = COUNTERS + INFONCE_COUNTERS
TC_COUNTERS = ("tc_fwd_launches", "tc_bwd_launches")  # kernels 2/3 on tensor
# cores: a subset of fwd_launches / bwd_launches
# kernels 4, 6, 7, 8 and 5 on their wgmma variant: subsets of the COUNTERS
# at WGMMA_OF
WGMMA_COUNTERS = ("chunk_fwd_wgmma_launches", "tiled_fwd_wgmma_launches",
                  "tiled_dq_wgmma_launches", "tiled_dkv_wgmma_launches",
                  "chunk_bwd_wgmma_launches")
WGMMA_OF = (2, 4, 5, 6, 3)
# Launches of kernels (2, 3, 4, 5, 6, 7, 8, 9, 10, 11) in one train step.
# Flagship: 12 ViT-B/32 blocks at 145 tokens (single-block) and 12 mBERT
# layers at 64 tokens, a forward each for the texts and for the captions, a
# backward for the texts.  Slice: 24 ViT-L/14 blocks at 577 tokens (chunked)
# and 24 XLM-R layers at 64 tokens (single-block); with remat every block
# that takes a gradient runs its forward once more (its recompute).
# High-resolution: the slice's text launches, the 24 ViT-L/14 blocks at 2705
# tokens tiled (a forward, its recompute, one dq and one dk/dv launch a
# block).  Large batch: the flagship's 36 forwards in each of GradCache's
# two forward passes over 16 microbatches and its 24 backwards once per
# microbatch; each InfoNCE kernel twice (one launch per direction) for each
# of the 3 ITC losses.
FLAGSHIP_STEP_LAUNCHES = (36, 24, 0, 0, 0, 0, 0, 0, 0, 0)
SLICE_STEP_LAUNCHES = {True: (72, 24, 48, 24, 0, 0, 0, 0, 0, 0),  # remat on
                       False: (48, 24, 24, 24, 0, 0, 0, 0, 0, 0)}  # off
HIRES_STEP_LAUNCHES = {True: (72, 24, 0, 0, 48, 24, 24, 0, 0, 0),
                       False: (48, 24, 0, 0, 24, 24, 24, 0, 0, 0)}
LARGE_BATCH = 4096
LARGE_MICROBATCHES = 16
LARGE_STREAM_ROWS = 256
LARGE_STEP_LAUNCHES = (1152, 384, 0, 0, 0, 0, 0, 6, 6, 6)
# (name, M, N, ids) of kernels 9-11's checks, E = 256: the large-batch
# step's [4096] x [4096] (idx = arange), the same with every id twice, a
# ragged size, a ring block of the multi-device loss (256 q rows against
# 32 768 keys) and the scale config's 32 768 negatives on one card
INFONCE_SHAPES = [("path", LARGE_BATCH, LARGE_BATCH, "arange"),
                  ("dup", LARGE_BATCH, LARGE_BATCH, "half"),
                  ("ragged", 1000, 1000, "ragged"),
                  ("ring", 256, 32768, "ring"),
                  ("32k", 32768, 32768, "arange")]
# correctness only, not timed: a ragged last tile and a last split of one
# column (4097 = 32 * 128 + 1), every id twice
INFONCE_CHECK_SHAPES = [("split-edge", 33, 4097, "half")]
INFONCE_DIM = 256
INFONCE_INV_TEMP = 1.0 / 0.07
# the __global__ functions of kernels 9-11 and their merge passes
INFONCE_KERNELS = ("infonce_stats_kernel", "infonce_stats_merge_kernel",
                   "infonce_bwd_dq_kernel", "infonce_bwd_dk_kernel",
                   "infonce_bwd_merge_kernel")
WORDS = ("a man woman dog child rides walks runs red blue green bike street "
         "field beach ball water in on the with his her two people").split()


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def launches_per_batch(cfg) -> int:
    """Fused cross-attention launches per embed_images call: one per
    caption-interaction layer (3 + 2 + 2 = 7 at the flagship config)."""
    return cfg.model.caption_ca_layer + 2 * cfg.model.caption_interaction_layer


def card() -> str:
    """nvidia-smi's 'name, power.limit' line for card 0."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, flush, iters: int = 50) -> float:
    """Mean device ms of fn(), each call timed alone with CUDA events after
    `flush`, a write that evicts the 50 MB L2 cache (inputs come from
    device memory, as on the path) and keeps the card busy long enough
    for the host to queue fn() behind it, so the host's Python time is
    not counted as device time."""
    import torch

    for _ in range(3):
        fn()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for start, end in events:
        flush()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def bf16_ulp(x):
    import torch

    _, exp = torch.frexp(x.float().abs())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), exp - 8)


def kernel_phase(batch: int = 64, heads: int = 8, dh: int = 64):
    """Kernel 1 against its plain version at SHAPES (timed, beside its
    bound, the plain version and SDPA) and EDGE_SHAPES (checked only), in
    bf16 (the path's dtype) and f32, each launch on the body `fused_body`
    picks (read from the per-body counters)."""
    import torch
    import torch.nn.functional as F

    from leccr_torch.ops.fused_cross_attention import (
        fused_body,
        fused_cross_attention,
        fused_cross_attention_reference,
    )

    flush_buf = torch.empty(2 ** 30, dtype=torch.uint8, device="cuda")
    flush = flush_buf.zero_
    results = []
    for lq, lk in SHAPES + EDGE_SHAPES:
        timed = (lq, lk) in SHAPES
        for dtype in (torch.bfloat16, torch.float32):
            g = torch.Generator(device="cuda").manual_seed(lq * 1000 + lk)
            # the path's layout: [B, L, H, Dh] storage seen as [B, H, L, Dh]
            q, k, v = (torch.randn(batch, n, heads, dh, device="cuda",
                                   generator=g).to(dtype).transpose(1, 2)
                       for n in (lq, lk, lk))
            pad = torch.rand(batch, lk, device="cuda", generator=g) < 0.3
            pad[0] = True  # fully padded row: the mean of v
            pad[1] = False
            body = fused_body(lq, lk, dh, q.element_size(), True)
            before = dict(fused_cross_attention.launches_by_body)
            got = fused_cross_attention(q, k, v, pad)
            moved = {n: c - before[n] for n, c in
                     fused_cross_attention.launches_by_body.items() if c
                     != before[n]}
            if moved != {body: 1}:
                raise AssertionError(f"kernel 1 at {lq}x{lk} launched "
                                     f"{moved}, want the {body} body once")
            want = fused_cross_attention_reference(q, k, v, pad)
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs()
            err = diff.max().item()
            if not torch.isfinite(got).all():
                raise AssertionError(f"non-finite kernel output {lq}x{lk}")
            mean_v = v[0].float().mean(dim=1, keepdim=True).expand(-1, lq, -1)
            mean_err = (got[0].float() - mean_v).abs().max().item()
            if mean_err > 1e-2:
                raise AssertionError("fully padded row is not the mean of v")
            if dtype == torch.float32:
                ok, tol = err <= 1e-5, "max abs err <= 1e-5"
            else:
                ok = bool((diff <= 1e-5 + bf16_ulp(want)).all())
                tol = "every element within 1e-5 + 1 bf16 ulp"
            if not ok:
                raise AssertionError(f"kernel disagrees with its plain "
                                     f"version at {lq}x{lk} {dtype}: {err}")
            name = str(dtype).split(".")[-1]
            row = {"lq": lq, "lk": lk, "dtype": name, "body": body,
                   "max_abs_err": err, "padded_row_vs_mean_v": mean_err,
                   "tolerance": tol}
            if not timed:
                emit("kernel_edge_vs_plain", **row)
                continue
            attend = ~pad[:, None, None, :]
            ms = cuda_ms(lambda: fused_cross_attention(q, k, v, pad), flush)
            plain_ms = cuda_ms(
                lambda: fused_cross_attention_reference(q, k, v, pad), flush)
            library_ms = cuda_ms(
                lambda: F.scaled_dot_product_attention(q, k, v, attend),
                flush)
            item = q.element_size()
            n_bytes = (item * (2 * q.numel() + k.numel() + v.numel())
                       + pad.numel())  # q, k, v, out + the bool mask
            flops = 4 * batch * heads * lq * lk * dh
            t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / PEAK_FLOPS[name] * 1e3
            results.append({
                **row, "ms": ms, "plain_ms": plain_ms,
                "library_ms": library_ms, "bytes": n_bytes, "flops": flops,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations"})
            emit("kernel_vs_plain", **results[-1])
    return results


def sdpa_backward(q, k, v, grad, attend=None):
    """A call that runs F.scaled_dot_product_attention's backward alone:
    one forward is saved and its backward replayed (fresh dq, dk, dv each
    call, nothing accumulated), the yardstick of the kernels that compute
    dq, dk and dv from a saved forward."""
    import torch
    import torch.nn.functional as F

    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
    out = F.scaled_dot_product_attention(qg, kg, vg, attend)
    return lambda: torch.autograd.grad(out, (qg, kg, vg), grad,
                                       retain_graph=True)


def flash_term_scales(q, k, v, pad, lse, grad, seed, rate, out=None,
                      hg=None):
    """Per output element of kernels 2 and 3, the sum of the absolute
    values of the terms it adds up (|p|·|v| for out, |pd|ᵀ|g| for dv,
    |ds|·|k| for dq, |ds|ᵀ|q| for dk), from the plain formulas.  The
    kernels round p, pd and ds to bf16 where the TPU kernel does; a
    rounding that lands the other way for f32 noise moves a term by up to
    one ulp of it, so the error scales with these sums, not with the
    (possibly cancelling) result.

    With `out` (the forward's result) the sums are kernels 4 and 5's: the
    chunked rules (padded keys −inf, p = 0 where lse is −inf, the per-tile
    dropout mask, delta = rowsum(g·out)).  Their forward rounds the
    unnormalised p̃ = p·e^(lse−m) of each key tile, scaled back by the same
    factor, so a flipped rounding moves a term by about one ulp of p·|v|:
    the out sum stays |p|·|v|.  Kernels 6-8 follow the same rules with the
    tiled head group: `hg` is passed to the tile mask."""
    import torch

    from leccr_torch.ops.flash_attention import keep_mask, tile_keep_mask

    chunked = out is not None
    dt, scale = q.dtype, 1.0 / q.shape[-1] ** 0.5
    qf, kf, vf, gf = (t.float() for t in (q, k, v, grad))
    s = qf @ kf.transpose(-1, -2) * scale
    if pad is not None:
        s = torch.where(pad[:, None, None, :], -math.inf if chunked
                        else torch.finfo(torch.float32).min, s)
    p = torch.exp(s - lse[..., None])
    if chunked:
        p = torch.where(torch.isfinite(s) & torch.isfinite(lse)[..., None],
                        p, 0.0)
    keep = 1.0
    if rate and chunked:
        keep = tile_keep_mask(seed, *p.shape, rate, device=p.device, hg=hg)
    elif rate:
        keep = keep_mask(seed, *p.shape, rate, device=p.device)
    pd = (p * keep).to(dt).float().abs()
    dp = gf @ vf.transpose(-1, -2) * keep
    delta = ((gf * out.float()).sum(-1, keepdim=True) if chunked
             else (dp * p).sum(-1, keepdim=True))
    ds = (p * (dp - delta) * scale).to(dt).float().abs()
    return {"out": pd @ vf.abs(), "dv": pd.transpose(-1, -2) @ gf.abs(),
            "dq": ds @ kf.abs(), "dk": ds.transpose(-1, -2) @ qf.abs()}


def bf16_k_needed(got, want, scale) -> float:
    """The least k with |got - want| <= 1e-5 + k bf16 ulps of `scale`, for
    every element."""
    excess = ((got.float() - want.float()).abs() - 1e-5).clamp_min(0)
    return float((excess / bf16_ulp(scale)).max().item())


def path_layout(x, aligned: bool = True):
    """x [B, L, H, Dh] as the towers pass it: [B, L, H, Dh] storage seen as
    [B, H, L, Dh]; with aligned=False, in storage that starts one element
    past a 16-byte boundary (rows unaligned: the scalar variant)."""
    if not aligned:
        buf = x.new_empty(x.numel() + 1)[1:]
        x = buf.view(x.shape).copy_(x)
    return x.transpose(1, 2)


def kernel1_counts(what: str) -> dict:
    """Kernel 1's launches since reset_counts(), all and by body; `what`
    (a path) must have launched both the few-queries and the few-keys body
    and the general one never (the embed_images shapes)."""
    from leccr_torch.ops.fused_cross_attention import fused_cross_attention

    counts = {"all": fused_cross_attention.launches,
              **fused_cross_attention.launches_by_body}
    if (counts["few_queries"] == 0 or counts["few_keys"] == 0
            or counts["general"] != 0 or counts["all"] != sum(
                fused_cross_attention.launches_by_body.values())):
        raise AssertionError(f"{what} launched kernel 1's bodies {counts}")
    return counts


def tc_counts():
    """Launches of kernels 2/3 on the tensor-core variant so far."""
    from leccr_torch.ops.flash_attention import flash_tower_attention

    return tuple(getattr(flash_tower_attention, c) for c in TC_COUNTERS)


def wgmma_counts():
    """Launches of kernels 4, 6, 7, 8 and 5 on the wgmma variant so far."""
    from leccr_torch.ops.flash_attention import flash_tower_attention

    return tuple(getattr(flash_tower_attention, c) for c in WGMMA_COUNTERS)


def flash_phase(dh: int = 64, seed: int = 1234):
    """Kernels 2 and 3 against their plain versions at the path's shapes
    (and SCALAR_FLASH_SHAPE on the scalar variant), timed beside their
    bound, the plain version and SDPA; then their dropout masks read back
    bit for bit at the text shape."""
    import torch
    import torch.nn.functional as F

    from leccr_torch.ops.flash_attention import (
        flash_tower_attention_bwd,
        flash_tower_attention_bwd_reference,
        flash_tower_attention_fwd,
        flash_tower_attention_fwd_reference,
        keep_mask,
        single_block_variant,
    )

    flush_buf = torch.empty(2 ** 30, dtype=torch.uint8, device="cuda")
    flush = flush_buf.zero_
    results = []
    cases = [(shape, dtype, True) for shape in FLASH_SHAPES
             for dtype in (torch.bfloat16, torch.float32)]
    cases.append((SCALAR_FLASH_SHAPE, torch.bfloat16, False))
    for shape, dtype, aligned in cases:
        name, batch, heads, length, rate, masked, backward = shape
        g = torch.Generator(device="cuda").manual_seed(length)
        q, k, v, grad = (path_layout(torch.randn(
            batch, length, heads, dh, device="cuda", generator=g).to(dtype),
            aligned) for _ in range(4))
        pad = None
        if masked:
            pad = torch.rand(batch, length, device="cuda",
                             generator=g) < 0.3
            pad[0] = True  # a fully padded row
            pad[1] = False
        variant = single_block_variant(q, k, v, grad)
        if variant != ("tc" if dtype == torch.bfloat16 and aligned
                       else "scalar"):
            raise AssertionError(f"{name} {dtype} takes the {variant} "
                                 f"variant")
        before = tc_counts()
        out, lse = flash_tower_attention_fwd(q, k, v, pad, seed, rate)
        grads = flash_tower_attention_bwd(q, k, v, pad, lse, grad, seed,
                                          rate)
        tc_launched = tuple(a - b for a, b in zip(tc_counts(), before))
        if tc_launched != ((1, 1) if variant == "tc" else (0, 0)):
            raise AssertionError(f"{name} {dtype}: tensor-core launches "
                                 f"{tc_launched} on the {variant} variant")
        want_out, want_lse = flash_tower_attention_fwd_reference(
            q, k, v, pad, seed, rate)
        want_grads = flash_tower_attention_bwd_reference(
            q, k, v, pad, want_lse, grad, seed, rate)
        torch.cuda.synchronize()
        pairs = {"out": (out, want_out), "lse": (lse, want_lse),
                 **{n: (a, w) for n, a, w in zip(("dq", "dk", "dv"),
                                                  grads, want_grads)}}
        errs = {n: (a.float() - w.float()).abs().max().item()
                for n, (a, w) in pairs.items()}
        if not all(torch.isfinite(a).all() for a, _ in pairs.values()):
            raise AssertionError(f"non-finite flash output {name}")
        item = q.element_size()
        if dtype == torch.float32:
            ok = (errs["out"] <= 1e-5 and errs["lse"] <= 1e-5
                  and max(errs[n] for n in ("dq", "dk", "dv")) <= 1e-4)
            tol = "max abs err: out, lse <= 1e-5; dq, dk, dv <= 1e-4"
            k_needed = None
        else:
            scales = flash_term_scales(q, k, v, pad, want_lse, grad,
                                       seed, rate)
            k_needed = {n: bf16_k_needed(*pairs[n], scales[n])
                        for n in scales}
            del scales
            ok = (errs["lse"] <= 1e-5
                  and max(k_needed.values()) <= BF16_K)
            tol = (f"lse <= 1e-5; out, dq, dk, dv: every element "
                   f"within 1e-5 + {BF16_K} bf16 ulps of the sum of "
                   f"the absolute values of its terms")
        if not ok:
            raise AssertionError(
                f"flash kernels disagree with their plain versions at "
                f"{name} {dtype}: {errs} ulps {k_needed}")
        numel = q.numel()
        lse_bytes = 4 * batch * heads * length
        mask_bytes = 0 if pad is None else pad.numel()
        n_bytes = {"fwd": 4 * numel * item + lse_bytes + mask_bytes,
                   "bwd": 7 * numel * item + lse_bytes + mask_bytes}
        flops = {"fwd": 4 * batch * heads * length * length * dh,
                 "bwd": 10 * batch * heads * length * length * dh}
        dname = str(dtype).split(".")[-1]
        attend = None if pad is None else ~pad[:, None, None, :]
        # SDPA refuses rows off 16-byte alignment: it gets aligned copies
        sdpa_in = [t if aligned else t.clone() for t in (q, k, v, grad)]
        times = {
            "fwd": (lambda: flash_tower_attention_fwd(
                        q, k, v, pad, seed, rate),
                    lambda: flash_tower_attention_fwd_reference(
                        q, k, v, pad, seed, rate),
                    lambda: F.scaled_dot_product_attention(
                        *sdpa_in[:3], attend))}
        if backward:
            times["bwd"] = (
                lambda: flash_tower_attention_bwd(
                    q, k, v, pad, lse, grad, seed, rate),
                lambda: flash_tower_attention_bwd_reference(
                    q, k, v, pad, lse, grad, seed, rate),
                sdpa_backward(*sdpa_in, attend))
        for direction, (kernel, plain, library) in times.items():
            t_bytes = n_bytes[direction] / HBM_BYTES_PER_S * 1e3
            t_ops = flops[direction] / PEAK_FLOPS[dname] * 1e3
            results.append({
                "shape": name, "direction": direction, "dtype": dname,
                "variant": variant, "b": batch, "h": heads, "l": length,
                "dh": dh, "rate": rate, "masked": masked,
                "max_abs_err": errs, "bf16_ulps": k_needed,
                "tolerance": tol,
                "ms": cuda_ms(kernel, flush, FLASH_ITERS),
                "plain_ms": cuda_ms(plain, flush, FLASH_ITERS),
                "library_ms": cuda_ms(library, flush, FLASH_ITERS),
                "library": ("F.scaled_dot_product_attention, rate 0"
                            + (" (backward alone, of a saved forward)"
                               if direction == "bwd" else "")),
                "bytes": n_bytes[direction], "flops": flops[direction],
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations"})
            emit("flash_vs_plain", **results[-1])
        del q, k, v, grad, sdpa_in, times
    # the masks each kernel applies, bit for bit, at the text shape
    _, batch, heads, length, rate, _, _ = FLASH_SHAPES[1]
    want = keep_mask(seed, batch, heads, length, length, rate,
                     device="cuda") != 0
    before = tc_counts()
    masks = single_masks(batch, heads, length, torch.bfloat16, rate, seed)
    equal = [bool(torch.equal(m, want)) for m in masks]
    tc_launched = tuple(a - b for a, b in zip(tc_counts(), before))
    emit("flash_masks", shape=[batch, heads, length, length], rate=rate,
         kernels=["forward (out)", "backward dq pass (dq)",
                  "backward dk/dv pass (dv)"],
         equal=equal, kept_share=want.float().mean().item(),
         tc_launches=tc_launched)
    if not all(equal) or 0 in tc_launched:
        raise AssertionError(f"kernels 2/3's masks differ from keep_mask: "
                             f"{equal}, tensor-core launches {tc_launched}")
    return results


def single_masks(batch, heads, length, dtype, rate, seed, dh=64):
    """The dropout masks that kernel 2 and kernel 3's two passes apply, read
    back bit for bit ([B, H, L, L] bool, True = kept), one block of dh keys
    (or queries) at a time.  With q = k = 0 every score is 0 and the
    forward's p is 1/L, so with v the identity on keys [c, c + dh) its
    out[i, d] = round(keep_ij / L) for j = c + d is nonzero exactly where
    (i, j) is kept.  The backward is given lse = log(2L), so p = 1/(2L) and
    sum_j p = 1/2: with k = v = that identity and g = 1 the dq pass has
    dp_ij = keep_ij on the block, delta_i = sum_j keep_ij / (2L) <= keep/2
    and ds_ij = p (dp_ij - delta_i) scale, positive exactly where kept, so
    dq[i, d] = round(ds_ij) > 0 there; with g the identity on queries
    [c, c + dh) and q = k = v = 0 the dk/dv pass gives dv[j, d] =
    round(pd_ij) for i = c + d, nonzero exactly where kept."""
    import torch

    from leccr_torch.ops.flash_attention import (
        flash_tower_attention_bwd,
        flash_tower_attention_fwd,
    )

    shape = (batch, length, heads, dh)
    zeros = path_layout(torch.zeros(shape, dtype=dtype, device="cuda"))
    ones = path_layout(torch.ones(shape, dtype=dtype, device="cuda"))
    lse = torch.full((batch, heads, length), math.log(2 * length),
                     dtype=torch.float32, device="cuda")
    masks = [torch.empty((batch, heads, length, length), dtype=torch.bool,
                         device="cuda") for _ in range(3)]
    eye = torch.eye(dh, dtype=dtype, device="cuda")
    for c in range(0, length, dh):
        n = min(dh, length - c)
        block = torch.zeros(shape, dtype=dtype, device="cuda")
        block[:, c:c + n] = eye[:n][None, :, None, :]
        block = path_layout(block)
        out, _ = flash_tower_attention_fwd(zeros, zeros, block, None, seed,
                                           rate)
        masks[0][..., c:c + n] = out[..., :n] != 0
        dq, _, _ = flash_tower_attention_bwd(zeros, block, block, None, lse,
                                             ones, seed, rate)
        masks[1][..., c:c + n] = dq[..., :n] > 0
        _, _, dv = flash_tower_attention_bwd(zeros, zeros, zeros, None, lse,
                                             block, seed, rate)
        masks[2][:, :, c:c + n, :] = (dv[..., :n] != 0).transpose(-1, -2)
    return masks


def chunked_phase(dh: int = 64, seed: int = 1234):
    """Kernels 4 and 5 against their plain versions at CHUNKED_SHAPES, bf16
    and f32, timed beside their bound, the plain version and SDPA.  Every
    bf16 forward must run kernel 4's wgmma variant, f32 the scalar one, and
    with dropout kernel 4's mask, read back bit for bit on that variant,
    must equal the plain hash at the chunked head group."""
    import torch
    import torch.nn.functional as F

    from leccr_torch.ops.flash_attention import (
        chunk_head_group,
        flash_chunked_attention_bwd,
        flash_chunked_attention_bwd_reference,
        flash_chunked_attention_fwd,
        flash_chunked_attention_fwd_reference,
        tile_keep_mask,
        tiled_variant,
    )

    flush_buf = torch.empty(2 ** 30, dtype=torch.uint8, device="cuda")
    flush = flush_buf.zero_
    results = []
    for name, batch, heads, length, rate, masked in CHUNKED_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            g = torch.Generator(device="cuda").manual_seed(length)
            # the path's layout: [B, L, H, Dh] storage seen as [B, H, L, Dh]
            q, k, v, grad = (torch.randn(batch, length, heads, dh,
                                         device="cuda", generator=g)
                             .to(dtype).transpose(1, 2) for _ in range(4))
            pad = None
            if masked:
                pad = torch.rand(batch, length, device="cuda",
                                 generator=g) < 0.3
                pad[0] = True  # a fully padded row: out 0, lse -inf
                pad[1] = False
            want_out, want_lse = flash_chunked_attention_fwd_reference(
                q, k, v, pad, seed, rate)
            want_grads = flash_chunked_attention_bwd_reference(
                q, k, v, pad, want_out, want_lse, grad, seed, rate)
            before = wgmma_counts()
            out, lse = flash_chunked_attention_fwd(q, k, v, pad, seed, rate)
            grads = flash_chunked_attention_bwd(q, k, v, pad, out, lse, grad,
                                                seed, rate)
            torch.cuda.synchronize()
            # bf16 at Dh = 64 (every call of the step) takes the wgmma bodies
            variant = tiled_variant(q, k, v)
            bwd_variant = tiled_variant(q, k, v, grad, out)
            bf16 = dtype == torch.bfloat16
            want = "wgmma" if bf16 else "scalar"
            if (variant != want or bwd_variant != want
                    or not wgmma_launched(before, chunk_fwd=int(bf16),
                                          chunk_bwd=int(bf16))):
                raise AssertionError(f"kernels 4/5 at {name} {dtype} took "
                                     f"the {variant}/{bwd_variant} variants")
            real = torch.isfinite(want_lse)
            if not torch.equal(torch.isfinite(lse), real):
                raise AssertionError(f"lse is -inf on other rows {name}")
            if masked and not ((out[0] == 0).all() and all(
                    (d[0] == 0).all() for d in grads)):
                raise AssertionError("a fully padded row must give out 0 "
                                     "and zero gradients")
            pairs = {"out": (out, want_out),
                     "lse": (lse[real], want_lse[real]),
                     **{n: (a, w) for n, a, w in zip(("dq", "dk", "dv"),
                                                      grads, want_grads)}}
            errs = {n: (a.float() - w.float()).abs().max().item()
                    for n, (a, w) in pairs.items()}
            if not all(torch.isfinite(a).all() for a, _ in pairs.values()):
                raise AssertionError(f"non-finite chunked output {name}")
            if dtype == torch.float32:
                ok = (errs["out"] <= 1e-5 and errs["lse"] <= 1e-5
                      and max(errs[n] for n in ("dq", "dk", "dv")) <= 1e-4)
                tol = "max abs err: out, lse <= 1e-5; dq, dk, dv <= 1e-4"
                k_needed = None
            else:
                scales = flash_term_scales(q, k, v, pad, want_lse, grad,
                                           seed, rate, out=want_out)
                k_needed = {n: bf16_k_needed(*pairs[n], scales[n])
                            for n in scales}
                del scales
                ok = (errs["lse"] <= 1e-5
                      and max(k_needed.values()) <= BF16_K)
                tol = (f"lse <= 1e-5; out, dq, dk, dv: every element "
                       f"within 1e-5 + {BF16_K} bf16 ulps of the sum of "
                       f"the absolute values of its terms (chunked rules)")
            if not ok:
                raise AssertionError(
                    f"chunked kernels disagree with their plain versions at "
                    f"{name} {dtype}: {errs} ulps {k_needed}")
            del grads, pairs
            mask_check = None
            if rate and bf16:  # kernel 4's mask on its wgmma variant
                plain = tile_keep_mask(seed, batch, heads, length, length,
                                       rate, device="cuda",
                                       hg=chunk_head_group(heads)) != 0
                before = wgmma_counts()
                got = fwd_masks(flash_chunked_attention_fwd, batch, heads,
                                length, dtype, rate, seed, dh)
                mask_check = {"kernel_4_equals_plain": torch.equal(got, plain),
                              "variant": variant,
                              "head_group": chunk_head_group(heads),
                              "kept_share": plain.float().mean().item()}
                if not mask_check["kernel_4_equals_plain"]:
                    raise AssertionError(f"kernel 4's dropout mask differs "
                                         f"from the plain hash at {name}")
                if not wgmma_launched(before, chunk_fwd=-(-length // dh)):
                    raise AssertionError(f"kernel 4's mask at {name} was not "
                                         f"read on the wgmma variant")
                del plain, got
            item = q.element_size()
            numel = q.numel()
            lse_bytes = 4 * batch * heads * length
            mask_bytes = 0 if pad is None else pad.numel()
            # forward: q, k, v -> out, lse; backward: q, k, v, out, g, lse
            # -> dq, dk, dv
            n_bytes = {"fwd": 4 * numel * item + lse_bytes + mask_bytes,
                       "bwd": 8 * numel * item + lse_bytes + mask_bytes}
            flops = {"fwd": 4 * batch * heads * length * length * dh,
                     "bwd": 10 * batch * heads * length * length * dh}
            dname = str(dtype).split(".")[-1]
            attend = None if pad is None else ~pad[:, None, None, :]
            times = {
                "fwd": (lambda: flash_chunked_attention_fwd(
                            q, k, v, pad, seed, rate),
                        lambda: flash_chunked_attention_fwd_reference(
                            q, k, v, pad, seed, rate),
                        lambda: F.scaled_dot_product_attention(
                            q, k, v, attend)),
                "bwd": (lambda: flash_chunked_attention_bwd(
                            q, k, v, pad, out, lse, grad, seed, rate),
                        lambda: flash_chunked_attention_bwd_reference(
                            q, k, v, pad, out, lse, grad, seed, rate),
                        sdpa_backward(q, k, v, grad, attend)),
            }
            for direction, (kernel, plain, library) in times.items():
                t_bytes = n_bytes[direction] / HBM_BYTES_PER_S * 1e3
                t_ops = flops[direction] / PEAK_FLOPS[dname] * 1e3
                results.append({
                    "shape": name, "direction": direction, "dtype": dname,
                    "b": batch, "h": heads, "l": length, "dh": dh,
                    "rate": rate, "masked": masked,
                    "variant": variant if direction == "fwd" else bwd_variant,
                    "masks": mask_check if direction == "fwd" else None,
                    "max_abs_err": errs,
                    "bf16_ulps": k_needed, "tolerance": tol,
                    "ms": cuda_ms(kernel, flush, FLASH_ITERS),
                    "plain_ms": cuda_ms(plain, flush, FLASH_ITERS),
                    "library_ms": cuda_ms(library, flush, FLASH_ITERS),
                    "library": ("F.scaled_dot_product_attention, rate 0"
                                + (" (backward alone, of a saved forward)"
                                   if direction == "bwd" else "")),
                    "bytes": n_bytes[direction], "flops": flops[direction],
                    "bound_ms": max(t_bytes, t_ops),
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations"})
                emit("chunked_vs_plain", **results[-1])
            del q, k, v, grad, times, out, lse, want_out, want_grads
            torch.cuda.empty_cache()
    results += chunked_ragged_checks(dh, seed)
    return results


def chunk_bwd_masks(batch, heads, length, dtype, rate, seed, dh=64):
    """The dropout masks that kernel 5's dq and dk/dv passes apply, read back
    bit for bit ([B, H, Lq, Lk] bool, True = kept), two launch pairs per
    64-row block: with q = 0, k = v = the identity on key block [c, c + 64),
    g = 1 and out = 0 (delta 0), dq[i, d] = ds[i, c + d]; with q = k = v = 0
    and g the identity on query block c, dv[j, d] = pd[c + d, j]."""
    import torch

    from leccr_torch.ops.flash_attention import (
        flash_chunked_attention_bwd,
        flash_chunked_attention_fwd,
    )

    shape = (batch, length, heads, dh)
    zeros = path_layout(torch.zeros(shape, dtype=dtype, device="cuda"))
    ones = path_layout(torch.ones(shape, dtype=dtype, device="cuda"))
    _, lse = flash_chunked_attention_fwd(zeros, zeros, zeros, None, seed,
                                         rate)
    masks = [torch.empty((batch, heads, length, length), dtype=torch.bool,
                         device="cuda") for _ in range(2)]
    for c, n, block in identity_blocks(batch, heads, length, dtype, dh):
        dq, _, _ = flash_chunked_attention_bwd(zeros, block, block, None,
                                               zeros, lse, ones, seed, rate)
        masks[0][..., c:c + n] = dq[..., :n] != 0
        _, _, dv = flash_chunked_attention_bwd(zeros, zeros, zeros, None,
                                               zeros, lse, block, seed, rate)
        masks[1][:, :, c:c + n, :] = (dv[..., :n] != 0).transpose(-1, -2)
    return masks


def chunked_ragged_checks(dh: int, seed: int):
    """Kernels 4 and 5 in bf16 at CHUNKED_RAGGED against their plain
    versions (the chunked bf16 tolerances), every launch on the wgmma
    variant, and kernel 5's dq-pass and dk/dv-pass dropout masks, read back
    bit for bit, equal to the plain hash at the chunked head group."""
    import torch

    from leccr_torch.ops.flash_attention import (
        chunk_head_group,
        flash_chunked_attention_bwd,
        flash_chunked_attention_bwd_reference,
        flash_chunked_attention_fwd,
        flash_chunked_attention_fwd_reference,
        tile_keep_mask,
    )

    results, rate = [], 0.1
    for length, heads in CHUNKED_RAGGED:
        q, k, v, grad, pad = tiled_inputs(2, heads, length, torch.bfloat16,
                                          True, seed + length + heads)
        before = wgmma_counts()
        out, lse = flash_chunked_attention_fwd(q, k, v, pad, seed, rate)
        grads = flash_chunked_attention_bwd(q, k, v, pad, out, lse, grad,
                                            seed, rate)
        if not wgmma_launched(before, chunk_fwd=1, chunk_bwd=1):
            raise AssertionError(f"kernels 4/5 at L={length}, H={heads} did "
                                 f"not take the wgmma variant")
        want_out, want_lse = flash_chunked_attention_fwd_reference(
            q, k, v, pad, seed, rate)
        want_grads = flash_chunked_attention_bwd_reference(
            q, k, v, pad, want_out, want_lse, grad, seed, rate)
        torch.cuda.synchronize()
        real = torch.isfinite(want_lse)
        if not torch.equal(torch.isfinite(lse), real):
            raise AssertionError(f"lse is -inf on other rows at L={length}")
        if not ((out[0] == 0).all() and all((d[0] == 0).all()
                                            for d in grads)):
            raise AssertionError("a fully padded row must give out 0 and "
                                 "zero gradients")
        pairs = {"out": (out, want_out),
                 **dict(zip(("dq", "dk", "dv"), zip(grads, want_grads)))}
        lse_err = ((lse[real] - want_lse[real]).abs().max().item()
                   if real.any() else 0.0)
        scales = flash_term_scales(q, k, v, pad, want_lse, grad, seed, rate,
                                   out=want_out)
        k_needed = {n: bf16_k_needed(*pairs[n], scales[n]) for n in scales}
        if lse_err > 1e-5 or max(k_needed.values()) > BF16_K:
            raise AssertionError(f"kernels 4/5 disagree with their plain "
                                 f"versions at L={length}, H={heads}: lse "
                                 f"{lse_err}, ulps {k_needed}")
        hg = chunk_head_group(heads)
        plain = tile_keep_mask(seed, 2, heads, length, length, rate,
                               device="cuda", hg=hg) != 0
        before = wgmma_counts()
        got = chunk_bwd_masks(2, heads, length, torch.bfloat16, rate, seed,
                              dh)
        blocks = -(-length // dh)
        equal = [torch.equal(m, plain) for m in got]
        if not all(equal):
            raise AssertionError(f"kernel 5's dropout masks differ from the "
                                 f"plain hash at L={length}, H={heads}")
        if not wgmma_launched(before, chunk_fwd=1, chunk_bwd=2 * blocks):
            raise AssertionError(f"kernel 5's masks at L={length} were not "
                                 f"read on the wgmma variant")
        results.append({"shape": f"ragged-{length}-h{heads}",
                        "direction": "fwd+bwd", "dtype": "bfloat16",
                        "b": 2, "h": heads, "l": length, "dh": dh,
                        "rate": rate, "masked": True, "variant": "wgmma",
                        "head_group": hg,
                        "max_abs_err": {"lse": lse_err, **{
                            n: (a.float() - w.float()).abs().max().item()
                            for n, (a, w) in pairs.items()}},
                        "bf16_ulps": k_needed,
                        "masks_5_dq_dkv_equal_plain": equal})
        emit("chunked_ragged_vs_plain", **results[-1])
    return results


def tiled_inputs(batch, heads, length, dtype, masked, seed, dh=64):
    """q, k, v, d(out) in the path's layout ([B, L, H, Dh] storage seen as
    [B, H, L, Dh]) and, with `masked`, a key padding mask with one fully
    padded row (example 0)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, grad = (torch.randn(batch, length, heads, dh, device="cuda",
                                 generator=g).to(dtype).transpose(1, 2)
                     for _ in range(4))
    pad = None
    if masked:
        pad = torch.rand(batch, length, device="cuda", generator=g) < 0.3
        pad[0] = True
        pad[1] = False
    return q, k, v, grad, pad


def identity_blocks(batch, heads, length, dtype, dh=64):
    """(c, n, block) for each block [c, c + n) of 64 rows: a [B, H, L, Dh]
    tensor in the path's layout, the identity on those rows, 0 elsewhere."""
    import torch

    eye = torch.eye(dh, dtype=dtype, device="cuda")
    for c in range(0, length, dh):
        n = min(dh, length - c)
        block = torch.zeros((batch, length, heads, dh), dtype=dtype,
                            device="cuda")
        block[:, c:c + n] = eye[:n][None, :, None, :]
        yield c, n, path_layout(block)


def fwd_masks(fwd, batch, heads, length, dtype, rate, seed, dh=64):
    """The dropout mask that a streamed forward (`fwd`: kernel 4's or 6's
    wrapper) applies, read back bit for bit ([B, H, Lq, Lk] bool, True =
    kept), one 64-key block per launch.  With q = k = 0 every score is 0
    and p = 1/L, so with v the identity on block [c, c + 64) out[i, d] is
    nonzero exactly where (i, c + d) is kept."""
    import torch

    zeros = path_layout(torch.zeros((batch, length, heads, dh), dtype=dtype,
                                    device="cuda"))
    mask = torch.empty((batch, heads, length, length), dtype=torch.bool,
                       device="cuda")
    for c, n, block in identity_blocks(batch, heads, length, dtype, dh):
        out, _ = fwd(zeros, zeros, block, None, seed, rate)
        mask[..., c:c + n] = out[..., :n] != 0
    return mask


def tiled_masks(batch, heads, length, dtype, rate, seed, dh=64):
    """The dropout masks that kernels 6, 7 and 8 apply, read back bit for
    bit ([B, H, Lq, Lk] bool, True = kept), one 64-key (or 64-query) block
    per launch: kernel 6's by `fwd_masks`; kernel 7 with q = 0, k = v =
    the identity on block [c, c + 64), g = 1 and out = 0 (delta 0) gives
    dq[i, d] = ds[i, c + d], and kernel 8 with g the identity on query
    block c gives dv[j, d] = pd[c + d, j]."""
    import torch

    from leccr_torch.ops.flash_attention import (
        flash_tiled_attention_dkv,
        flash_tiled_attention_dq,
        flash_tiled_attention_fwd,
    )

    shape = (batch, length, heads, dh)
    zeros = path_layout(torch.zeros(shape, dtype=dtype, device="cuda"))
    ones = path_layout(torch.ones(shape, dtype=dtype, device="cuda"))
    _, lse = flash_tiled_attention_fwd(zeros, zeros, zeros, None, seed, rate)
    delta = torch.zeros_like(lse)
    masks = [fwd_masks(flash_tiled_attention_fwd, batch, heads, length,
                       dtype, rate, seed, dh)]
    masks += [torch.empty((batch, heads, length, length), dtype=torch.bool,
                          device="cuda") for _ in range(2)]
    for c, n, block in identity_blocks(batch, heads, length, dtype, dh):
        dq, _ = flash_tiled_attention_dq(zeros, block, block, None, zeros,
                                         lse, ones, seed, rate)
        masks[1][..., c:c + n] = dq[..., :n] != 0
        _, dv = flash_tiled_attention_dkv(zeros, zeros, zeros, None, lse,
                                          delta, block, seed, rate)
        masks[2][:, :, c:c + n, :] = (dv[..., :n] != 0).transpose(-1, -2)
    return masks


def wgmma_launched(before, chunk_fwd=0, tiled_fwd=0, dq=0, dkv=0,
                   chunk_bwd=0) -> bool:
    """Whether the wgmma counters moved by exactly these launches (kernels
    4, 6, 7, 8 and 5) since `before` (a wgmma_counts())."""
    return (tuple(a - b for a, b in zip(wgmma_counts(), before))
            == (chunk_fwd, tiled_fwd, dq, dkv, chunk_bwd))


def tiled_phase(dh: int = 64, seed: int = 1234):
    """Kernels 6, 7 and 8 against their plain versions at TILED_SHAPES (out,
    lse, dq, delta, dk, dv; the masks each kernel applies bit for bit
    against the plain hash at head_group(H); every bf16 launch on the wgmma
    variant), then each timed per launch at the high-resolution step's
    [8, 16, 2705, 64] bf16 beside its bound, its plain version, SDPA and the
    chunked kernels 4/5 forced onto the same shape."""
    import torch
    import torch.nn.functional as F

    from leccr_torch.ops.flash_attention import (
        TILED_BWD_PERSISTENT,
        _launch_tiled_dkv,
        _launch_tiled_dq,
        chunk_head_group,
        flash_chunked_attention_bwd,
        flash_chunked_attention_fwd,
        flash_tiled_attention_dkv,
        flash_tiled_attention_dkv_reference,
        flash_tiled_attention_dq,
        flash_tiled_attention_dq_reference,
        flash_tiled_attention_fwd,
        flash_tiled_attention_fwd_reference,
        head_group,
        regime,
        tile_keep_mask,
        tiled_variant,
    )

    checks = []
    for name, batch, heads, length, dname, rate, masked in TILED_SHAPES:
        dtype = getattr(torch, dname)
        q, k, v, grad, pad = tiled_inputs(batch, heads, length, dtype,
                                          masked, seed + length)
        if regime(q, k) != "tiled":
            raise AssertionError(f"{name} does not dispatch to the tiled "
                                 f"kernels: {regime(q, k)}")
        want_out, want_lse = flash_tiled_attention_fwd_reference(
            q, k, v, pad, seed, rate)
        want_dq, want_delta = flash_tiled_attention_dq_reference(
            q, k, v, pad, want_out, want_lse, grad, seed, rate)
        want_dk, want_dv = flash_tiled_attention_dkv_reference(
            q, k, v, pad, want_lse, want_delta, grad, seed, rate)
        before = wgmma_counts()
        out, lse = flash_tiled_attention_fwd(q, k, v, pad, seed, rate)
        dq, delta = flash_tiled_attention_dq(q, k, v, pad, out, lse, grad,
                                             seed, rate)
        dk, dv = flash_tiled_attention_dkv(q, k, v, pad, lse, delta, grad,
                                           seed, rate)
        torch.cuda.synchronize()
        # bf16 at Dh = 64 (every shape of the step) takes the wgmma kernels
        variant = tiled_variant(q, k, v, grad, out)
        n = int(variant == "wgmma")
        if (variant != ("wgmma" if dname == "bfloat16" else "scalar")
                or not wgmma_launched(before, 0, n, n, n)):
            raise AssertionError(f"kernels 6-8 at {name} took the {variant} "
                                 f"variant")
        real = torch.isfinite(want_lse)
        if not torch.equal(torch.isfinite(lse), real):
            raise AssertionError(f"lse is -inf on other rows {name}")
        if masked and not ((out[0] == 0).all() and (dq[0] == 0).all()
                           and (dk[0] == 0).all() and (dv[0] == 0).all()):
            raise AssertionError("a fully padded row must give out 0 and "
                                 "zero gradients")
        # kernel 7's delta sums g·out of the kernel's own rounded output
        own_delta = (grad.float() * out.float()).sum(dim=-1)
        pairs = {"out": (out, want_out), "lse": (lse[real], want_lse[real]),
                 "dq": (dq, want_dq), "delta": (delta, own_delta),
                 "dk": (dk, want_dk), "dv": (dv, want_dv)}
        errs = {n: (a.float() - w.float()).abs().max().item()
                for n, (a, w) in pairs.items()}
        if not all(torch.isfinite(a).all() for a, _ in pairs.values()):
            raise AssertionError(f"non-finite tiled output {name}")
        if dtype == torch.float32:
            ok = (errs["out"] <= 1e-5 and errs["lse"] <= 1e-5
                  and max(errs[n] for n in ("dq", "delta", "dk", "dv"))
                  <= 1e-4)
            tol = ("max abs err: out, lse <= 1e-5; dq, dk, dv, delta (against "
                   "rowsum(g·out) of the kernel's out) <= 1e-4")
            k_needed = None
        else:
            scales = flash_term_scales(q, k, v, pad, want_lse, grad, seed,
                                       rate, out=want_out,
                                       hg=head_group(heads))
            k_needed = {n: bf16_k_needed(*pairs[n], scales[n])
                        for n in scales}
            del scales
            ok = (errs["lse"] <= 1e-5
                  and errs["delta"] <= 1e-5 * max(
                      1.0, own_delta.abs().max().item())
                  and max(k_needed.values()) <= BF16_K)
            tol = (f"lse <= 1e-5, delta <= 1e-5 max(1, |delta|) against "
                   f"rowsum(g·out) of the kernel's out; out, dq, dk, dv: "
                   f"every element within 1e-5 + {BF16_K} bf16 ulps of the "
                   f"sum of the absolute values of its terms (tiled rules)")
        if not ok:
            raise AssertionError(
                f"tiled kernels disagree with their plain versions at "
                f"{name} {dname}: {errs} ulps {k_needed}")
        del q, k, v, grad, pairs, out, lse, dq, delta, dk, dv, own_delta
        del want_out, want_lse, want_dq, want_delta, want_dk, want_dv
        mask_check = None
        if rate:
            plain = tile_keep_mask(seed, batch, heads, length, length, rate,
                                   device="cuda", hg=head_group(heads)) != 0
            before = wgmma_counts()
            got = tiled_masks(batch, heads, length, dtype, rate, seed, dh)
            equal = [torch.equal(m, plain) for m in got]
            # kernels 6-8 read back on the variant this shape takes (6 once
            # more, for the lse that 7 and 8 take)
            blocks = -(-length // dh) * (variant == "wgmma")
            if not wgmma_launched(before, 0, blocks + n, blocks, blocks):
                raise AssertionError(f"kernels 6-8's masks at {name} were "
                                     f"not read on the {variant} variant")
            chunked = tile_keep_mask(seed, batch, heads, length, length, rate,
                                     device="cuda",
                                     hg=chunk_head_group(heads)) != 0
            mask_check = {"kernels_6_7_8_equal_plain": equal,
                          "variant_6_7_8": variant,
                          "kept_share": plain.float().mean().item(),
                          "head_group": head_group(heads),
                          "equals_chunked_mask": torch.equal(plain, chunked)}
            if not all(equal):
                raise AssertionError(f"tiled dropout masks differ from the "
                                     f"plain hash at {name}: {equal}")
            del plain, got, chunked
        checks.append({"shape": name, "dtype": dname, "b": batch,
                       "h": heads, "l": length, "dh": dh, "rate": rate,
                       "masked": masked, "variant_6_7_8": variant,
                       "max_abs_err": errs,
                       "bf16_ulps": k_needed, "tolerance": tol,
                       "masks": mask_check})
        emit("tiled_vs_plain", **checks[-1])
        torch.cuda.empty_cache()

    # per launch at the high-resolution step's ViT calls (bf16, rate 0, no
    # padding), L2 flushed
    batch, heads, length = TILED_TIMED
    q, k, v, grad, _ = tiled_inputs(batch, heads, length, torch.bfloat16,
                                    False, seed)
    before = wgmma_counts()
    out, lse = flash_tiled_attention_fwd(q, k, v, None, seed, 0.0)
    _, delta = flash_tiled_attention_dq(q, k, v, None, out, lse, grad, seed,
                                        0.0)
    if (tiled_variant(q, k, v, grad, out) != "wgmma"
            or not wgmma_launched(before, 0, 1, 1, 0)):
        raise AssertionError("the timed shape must take the wgmma kernels")
    flush_buf = torch.empty(2 ** 30, dtype=torch.uint8, device="cuda")
    flush = flush_buf.zero_
    numel, item = q.numel(), q.element_size()
    rows = 4 * batch * heads * length  # bytes of one [B, H, L] f32 row stat
    flops = 2 * batch * heads * length * length * dh  # one L x L product
    work = {  # (products, bytes: inputs read once, outputs written once)
        "fwd": (2, 4 * numel * item + rows),          # q k v -> out, lse
        "dq": (3, 6 * numel * item + 2 * rows),       # q k v out g -> dq
        "dkv": (4, 6 * numel * item + 2 * rows),      # q k v g -> dk dv
    }
    sdpa_fwd_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v),
                          flush, FLASH_ITERS)
    sdpa_bwd = sdpa_backward(q, k, v, grad)
    sdpa_bwd_ms = cuda_ms(sdpa_bwd, flush, FLASH_ITERS)
    del sdpa_bwd
    chunk_fwd_ms = cuda_ms(lambda: flash_chunked_attention_fwd(
        q, k, v, None, seed, 0.0), flush, FLASH_ITERS)
    chunk_bwd_ms = cuda_ms(lambda: flash_chunked_attention_bwd(
        q, k, v, None, out, lse, grad, seed, 0.0), flush, FLASH_ITERS)
    # kernels 7/8's two grids, in turns (one-tile, persistent, persistent,
    # one-tile): the schedule TILED_BWD_PERSISTENT fixes is the faster one
    passes = {"dq": lambda persistent: _launch_tiled_dq(
                  q, k, v, None, out, lse, grad, seed, 0.0, persistent),
              "dkv": lambda persistent: _launch_tiled_dkv(
                  q, k, v, None, lse, delta, grad, seed, 0.0, persistent)}
    schedules = {n: {"one_tile": [], "persistent": []} for n in passes}
    for persistent in (False, True, True, False):
        key = "persistent" if persistent else "one_tile"
        for n, run in passes.items():
            schedules[n][key].append(cuda_ms(lambda: run(persistent), flush,
                                             FLASH_ITERS))
    runs = {
        "fwd": (lambda: flash_tiled_attention_fwd(q, k, v, None, seed, 0.0),
                lambda: flash_tiled_attention_fwd_reference(
                    q, k, v, None, seed, 0.0)),
        "dq": (lambda: flash_tiled_attention_dq(q, k, v, None, out, lse,
                                                grad, seed, 0.0),
               lambda: flash_tiled_attention_dq_reference(
                   q, k, v, None, out, lse, grad, seed, 0.0)),
        "dkv": (lambda: flash_tiled_attention_dkv(q, k, v, None, lse, delta,
                                                  grad, seed, 0.0),
                lambda: flash_tiled_attention_dkv_reference(
                    q, k, v, None, lse, delta, grad, seed, 0.0)),
    }
    timed = {}
    for which, (kernel, plain) in runs.items():
        products, n_bytes = work[which]
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = products * flops / PEAK_FLOPS["bfloat16"] * 1e3
        timed[which] = {
            "ms": cuda_ms(kernel, flush, FLASH_ITERS),
            "plain_ms": cuda_ms(plain, flush, FLASH_ITERS),
            "bytes": n_bytes, "flops": products * flops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            # kernels 7 + 8 together do what SDPA's backward and kernel 5
            # each do in one call: that yardstick stands once, on the dq row
            "library_ms": {"fwd": sdpa_fwd_ms, "dq": sdpa_bwd_ms,
                           "dkv": None}[which],
            "library": {
                "fwd": "F.scaled_dot_product_attention, forward",
                "dq": ("F.scaled_dot_product_attention, backward alone of a "
                       "saved forward (dq, dk and dv at once): the "
                       "yardstick of kernels 7 + 8 together"),
                "dkv": ("none alone: SDPA's backward computes dq, dk and dv "
                        "at once and stands on flash_tiled_attention_dq's "
                        "row")}[which],
            "chunked_ms": {"fwd": chunk_fwd_ms, "dq": chunk_bwd_ms,
                           "dkv": None}[which],
            "chunked": {
                "fwd": ("kernel 4 at the same shape: the same wgmma body at "
                        "head group 2"),
                "dq": ("kernel 5 (its dq and dk/dv launches) at the same "
                       "shape: the same wgmma passes at head group 2, "
                       "persistent"),
                "dkv": "on flash_tiled_attention_dq's row"}[which]}
        if which in schedules:
            timed[which]["schedule"] = ("persistent" if TILED_BWD_PERSISTENT
                                        else "one_tile")
            timed[which]["schedules_ms"] = {
                k: sum(v) / len(v) for k, v in schedules[which].items()}
            timed[which]["schedules_runs_ms"] = schedules[which]
    timed["dq"]["pair_ms"] = timed["dq"]["ms"] + timed["dkv"]["ms"]
    for which in ("fwd", "dq", "dkv"):
        timed[which]["variant"] = "wgmma"
        timed[which]["tflops"] = (timed[which]["flops"] / timed[which]["ms"]
                                  / 1e9)
    emit("tiled_timed", b=batch, h=heads, l=length, dh=dh, dtype="bfloat16",
         rate=0.0, **timed)
    del q, k, v, grad, out, lse, delta, flush_buf
    torch.cuda.empty_cache()
    return {"checks": checks, "timed": timed}


def infonce_ids(kind: str, m: int, n: int, device):
    """(idx_q, idx_k) of an INFONCE_SHAPES case: "arange" (every row its
    own id), "half" (every id twice), "ragged" (every id three times),
    "ring" (q's ids a strided subset of k's, every 8th q row with no
    positive at all)."""
    import torch

    def ar(r):
        return torch.arange(r, device=device)

    if kind == "half":
        return ar(m) // 2, ar(n) // 2
    if kind == "ragged":
        return ar(m) // 3, ar(n) // 3
    if kind == "ring":
        idx_q = ar(m) * (n // m)
        idx_q[::8] = -1 - ar(m)[::8]
        return idx_q, ar(n)
    return ar(m), ar(n)


def infonce_errors(stats, want, grads, want_grads, softmax_terms=None):
    """Kernels 9-11 against their plain versions: lse and pos_sum as
    max |Δ| / max(1, |plain|), pos_cnt as max |Δ|, dq_raw and dk_raw as
    max |Δ| / max |plain|; under "abs" the max absolute errors.  Where a
    plain gradient is all zero (w = softmax − labels cancels exactly, as at
    [1] x [1] with one positive), its largest element is taken from
    `softmax_terms()`: the plain (dq_raw, dk_raw) of the softmax term
    alone, the terms that cancelled."""
    errs, absolute = {}, {}
    for name, got, ref in zip(("lse", "pos_sum", "pos_cnt", "dq", "dk"),
                              (*stats, *grads), (*want, *want_grads)):
        diff = (got.float() - ref.float()).abs()
        absolute[name] = diff.max().item()
        if name in ("lse", "pos_sum"):
            errs[name] = (diff / ref.abs().clamp_min(1.0)).max().item()
        elif name == "pos_cnt":
            errs[name] = absolute[name]
        else:
            scale = ref.abs().max().item()
            if scale == 0 and softmax_terms is not None:
                scale = softmax_terms()[name == "dk"].abs().max().item()
            errs[name] = absolute[name] / scale if scale > 0 else (
                0.0 if absolute[name] == 0 else math.inf)
    return {**errs, "abs": absolute}


def infonce_check(m: int, n: int, ids: str, e: int = INFONCE_DIM,
                  name: str = ""):
    """Kernels 9, 10 and 11 against their plain versions at q [m, e],
    k [n, e] (unit-norm rows from a seeded generator, `infonce_ids(ids)`,
    inv_temp 1/0.07 as a device tensor; the backward kernels take the plain
    lse and pos_cnt).  Tolerance: lse and pos_sum within 1e-5 of
    max(1, |x|), pos_cnt exact, dq_raw and dk_raw within 1e-4 of their
    largest element (of the softmax term's where they are all zero:
    `infonce_errors`); every output finite.  Returns (args, plain lse, plain
    pos_cnt, errors, the (row tiles, splits) each kernel launched)."""
    import torch
    import torch.nn.functional as F

    from leccr_torch.ops import infonce

    g = torch.Generator(device="cuda").manual_seed(m + n)
    q, k = (F.normalize(torch.randn(r, e, device="cuda", generator=g),
                        dim=-1) for r in (m, n))
    iq, ik = infonce_ids(ids, m, n, "cuda")
    invt = torch.tensor(INFONCE_INV_TEMP, device="cuda")
    args = (q, k, iq, ik, invt)
    stats = infonce.infonce_stats(*args)
    want = infonce.infonce_stats_reference(*args)
    lse, pc = want[0], want[2]
    grads = (infonce.infonce_bwd_dq(*args, lse, pc),
             infonce.infonce_bwd_dk(*args, lse, pc))
    want_grads = (infonce.infonce_bwd_dq_reference(*args, lse, pc),
                  infonce.infonce_bwd_dk_reference(*args, lse, pc))
    torch.cuda.synchronize()
    if not all(torch.isfinite(t).all() for t in (*stats, *grads)):
        raise AssertionError(f"non-finite InfoNCE kernel output {name}")
    no_match = torch.full_like(ik, min(iq.min(), ik.min()).item() - 1)
    errs = infonce_errors(stats, want, grads, want_grads, lambda: (
        infonce.infonce_bwd_dq_reference(q, k, iq, no_match, invt, lse, pc),
        infonce.infonce_bwd_dk_reference(q, k, iq, no_match, invt, lse, pc)))
    if not (errs["pos_cnt"] == 0 and errs["lse"] <= 1e-5
            and errs["pos_sum"] <= 1e-5 and errs["dq"] <= 1e-4
            and errs["dk"] <= 1e-4):
        raise AssertionError(f"InfoNCE kernels disagree with their plain "
                             f"versions at {name} [{m}] x [{n}], E={e}: "
                             f"{errs}")
    return args, lse, pc, errs, dict(infonce.last_grid)


def infonce_deterministic(args, lse, pc) -> bool:
    """Two calls of each of kernels 9, 10 and 11 give the same bits."""
    import torch

    from leccr_torch.ops import infonce

    runs = [(*infonce.infonce_stats(*args),
             infonce.infonce_bwd_dq(*args, lse, pc),
             infonce.infonce_bwd_dk(*args, lse, pc)) for _ in range(2)]
    return all(torch.equal(a, b) for a, b in zip(*runs))


def infonce_phase(iters: int = 20):
    """Kernels 9, 10 and 11 against their plain versions (`infonce_check`)
    at INFONCE_SHAPES and, untimed, INFONCE_CHECK_SHAPES; two calls of each
    bit-identical at the path shape.  Each kernel, its plain version and
    the dense composition the port does not call (q kᵀ, logsumexp and the
    masked sums; for the backward the autograd of that dense half loss,
    which gives dq and dk together) are timed with the L2 flushed, beside
    the bound: flops at the f32 rate against the bytes in and out; each
    kernel's row gives the grid it launched (splits, blocks), TFLOP/s and
    ms / bound."""
    import torch

    from leccr_torch.ops import infonce

    for name, m, n, ids in INFONCE_CHECK_SHAPES:
        errs, grid = infonce_check(m, n, ids, name=name)[3:]
        emit("infonce_check", shape=name, m=m, n=n, e=INFONCE_DIM, ids=ids,
             errors=errs, grid=grid)
    flush_buf = torch.empty(2 ** 30, dtype=torch.uint8, device="cuda")
    flush = flush_buf.zero_
    e = INFONCE_DIM
    results = []
    for name, m, n, ids in INFONCE_SHAPES:
        args, lse, pc, errs, grid = infonce_check(m, n, ids, name=name)
        q, k, iq, ik, invt = args
        if name == "path" and not infonce_deterministic(args, lse, pc):
            raise AssertionError("two calls of an InfoNCE kernel differ")
        qg, kg = (t.detach().requires_grad_(True) for t in (q, k))

        def dense_stats():
            logits = (q @ k.T) * invt
            pos = iq[:, None] == ik[None, :]
            return (torch.logsumexp(logits, 1),
                    torch.where(pos, logits, 0.0).sum(1), pos.sum(1))

        def dense_half_loss_fwd_bwd():
            logits = (qg @ kg.T) * invt
            pos = iq[:, None] == ik[None, :]
            loss = (torch.logsumexp(logits, 1)
                    - torch.where(pos, logits, 0.0).sum(1)
                    / pos.sum(1).clamp_min(1)).mean()
            torch.autograd.grad(loss, (qg, kg))

        it = 3 if m * n > 2 ** 27 else iters
        composition_bwd = cuda_ms(dense_half_loss_fwd_bwd, flush, it)
        row = {"shape": name, "m": m, "n": n, "e": e, "ids": ids,
               "errors": errs,
               **({"bit_identical_calls": 2} if name == "path" else {}),
               "tolerance": "lse, pos_sum: |Δ| <= 1e-5 max(1, |x|); "
                            "pos_cnt exact; dq_raw, dk_raw: |Δ| <= 1e-4 "
                            "max |x|"}
        id_bytes = 4 * (m + n)  # the int32 ids the kernels read
        in_bytes = 4 * (m + n) * e + id_bytes + 4
        for kernel, fn, plain, flops, n_bytes, comp in (
                ("stats", lambda: infonce.infonce_stats(*args),
                 lambda: infonce.infonce_stats_reference(*args),
                 2 * m * n * e, in_bytes + 3 * 4 * m,
                 cuda_ms(dense_stats, flush, it)),
                ("dq", lambda: infonce.infonce_bwd_dq(*args, lse, pc),
                 lambda: infonce.infonce_bwd_dq_reference(*args, lse, pc),
                 4 * m * n * e, in_bytes + 8 * m + 4 * m * e,
                 composition_bwd),
                ("dk", lambda: infonce.infonce_bwd_dk(*args, lse, pc),
                 lambda: infonce.infonce_bwd_dk_reference(*args, lse, pc),
                 4 * m * n * e, in_bytes + 8 * m + 4 * n * e,
                 composition_bwd)):
            t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / PEAK_FLOPS["float32"] * 1e3
            ms = cuda_ms(fn, flush, it)
            row_tiles, splits = grid[kernel]
            row[kernel] = {
                "ms": ms, "plain_ms": cuda_ms(plain, flush, it),
                "composition_ms": comp, "flops": flops, "bytes": n_bytes,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "splits": splits, "blocks": row_tiles * splits,
                "tflops": flops / ms * 1e-9,
                "x_bound": ms / max(t_bytes, t_ops)}
        row["composition"] = (
            "stats: (q @ k.T) * inv_temp, torch.logsumexp and the masked "
            "sums; dq, dk: forward + autograd of that dense half loss (one "
            "direction of soft_label_contrastive_loss), both together")
        results.append(row)
        emit("infonce_vs_plain", **row)
        del q, k, qg, kg, lse, pc
        torch.cuda.empty_cache()
    return results


def loss_phase(cfg, batch: int = LARGE_BATCH, iters: int = 5, seed: int = 0):
    """compute_losses forward + backward of grad_total on `batch` random
    embeddings at the flagship's widths, in the two ways a step can take
    them: the fused InfoNCE (kernels 9-11) with the dstl and caption-vision
    losses streamed in LARGE_STREAM_ROWS-row blocks, and the dense gather
    losses.  Device ms (events around each synchronised call), peak memory
    beyond the inputs; the 10 loss keys agree within 1e-4 of max(1, |x|)."""
    import torch
    import torch.nn.functional as F

    from leccr_torch.models.clip import CLIP_VARIANTS
    from leccr_torch.models.leccr import TrainEmbeddings
    from leccr_torch.models.losses import LOSS_KEYS, compute_losses
    from leccr_torch.ops.infonce import infonce_loss
    from leccr_torch.train.step import grad_total

    mc = cfg.model
    dv, nq, e = (CLIP_VARIANTS[mc.vision.variant].embed_dim, mc.num_queries,
                 mc.embed_dim)
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*shape):
        return torch.randn(*shape, device="cuda", generator=g)

    fields = {"image_feat": F.normalize(rand(batch, e), dim=-1),
              "text_feat_s": F.normalize(rand(batch, e), dim=-1),
              "text_feat_t": F.normalize(rand(batch, e), dim=-1),
              "slots": rand(batch, nq, e) * 0.1,
              "ori_slots": rand(batch, nq, dv),
              "cv_caption_mean": rand(batch, dv) * 0.05,
              "cv_vision_mean": rand(batch, dv) * 0.05,
              "temp": torch.tensor(mc.temp, device="cuda")}
    idx = torch.arange(batch, device="cuda")
    modes = {"fused_streaming": (infonce_loss, LARGE_STREAM_ROWS),
             "dense": (None, 0)}
    out, values = {}, {}
    for mode, (itc, rows) in modes.items():
        def run():
            leaves = {n: t.detach().requires_grad_(True)
                      for n, t in fields.items()}
            losses = compute_losses(
                TrainEmbeddings(**leaves), idx,
                weight_caption_loss=mc.weight_caption_loss,
                weight_reg_loss=mc.weight_reg_loss,
                weight_dstl_loss=mc.weight_dstl_loss,
                weight_cv_loss=mc.weight_cv_loss, dstl_alpha=mc.dstl_alpha,
                itc_loss_fn=itc, stream_block_rows=rows)
            grad_total(losses, mc).backward()
            return losses

        losses = run()
        torch.cuda.synchronize()
        values[mode] = {k: losses[k].item() for k in LOSS_KEYS}
        del losses
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ms = []
        for _ in range(iters):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            torch.cuda.synchronize()
            start.record()
            run()
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
        out[mode] = {"ms": sum(ms) / iters, "ms_min": min(ms),
                     "peak_mem_gb": (torch.cuda.max_memory_allocated()
                                     - base) / 1e9}
    err = max(abs(values["fused_streaming"][k] - values["dense"][k])
              / max(1.0, abs(values["dense"][k])) for k in LOSS_KEYS)
    if not err <= 1e-4:
        raise AssertionError(f"fused + streaming losses differ from the "
                             f"dense ones by {err}")
    emit("loss_fwd_bwd", batch=batch, embed_dim=e,
         stream_rows=LARGE_STREAM_ROWS, iters=iters, max_rel_loss_err=err, tolerance="1e-4 max(1, |x|)",
         total=values["dense"]["total"], **out)
    return out


def step_counts():
    """Launches of the training kernels (2-11) so far."""
    from leccr_torch.ops import infonce
    from leccr_torch.ops.flash_attention import flash_tower_attention

    return (tuple(getattr(flash_tower_attention, c) for c in COUNTERS)
            + tuple(getattr(infonce, c) for c in INFONCE_COUNTERS))


def reset_counts() -> None:
    from leccr_torch.ops import infonce
    from leccr_torch.ops.flash_attention import flash_tower_attention
    from leccr_torch.ops.fused_cross_attention import fused_cross_attention

    for c in COUNTERS + TC_COUNTERS + WGMMA_COUNTERS:
        setattr(flash_tower_attention, c, 0)
    for c in INFONCE_COUNTERS:
        setattr(infonce, c, 0)
    fused_cross_attention.launches = 0
    for body in fused_cross_attention.launches_by_body:
        fused_cross_attention.launches_by_body[body] = 0


def train_batch(cfg, batch: int, width: int, seed: int):
    """bench.py's train-step inputs on the card: uint8 images, random flips,
    texts and captions at one token width with all-ones masks except one
    padded source text, idx = arange(batch)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    res, vocab = cfg.model.vision.image_res, cfg.model.text.vocab_size
    out = {
        "vision": torch.randint(0, 256, (batch, res, res, 3),
                                dtype=torch.uint8, device="cuda",
                                generator=g),
        "flip": torch.rand(batch, device="cuda", generator=g) < 0.5,
        "idx": torch.arange(batch, device="cuda"),
    }
    for key in ("text_s", "text_t", "caption"):
        ids = torch.randint(1, vocab, (batch, width), device="cuda",
                            generator=g)
        mask = torch.ones_like(ids, dtype=torch.int32)
        if key == "text_s":
            mask[1, width // 3:] = 0
            ids = ids * mask
        name = key.split("_")[0]
        suffix = key[len(name):]
        out[f"{name}_ids{suffix}"] = ids
        out[f"{name}_mask{suffix}"] = mask
    return out


def set_options(cfg, options) -> None:
    """Set dotted config options ({"parallel.negatives": "fused", ...})."""
    for key, value in options.items():
        node = cfg
        *path, last = key.split(".")
        for part in path:
            node = getattr(node, part)
        setattr(node, last, value)


def train_grad_check_phase(cfg, modes, phase: str = "train_grad_check",
                           seed: int = 0, n: int = 4, width: int = 64,
                           loss_tol=None):
    """The full-width model in f32, dropouts at 0: grad_total's gradients
    of one step in each of `modes` ({name: (fused, remat, dtype, launches
    of kernels 2-11 the step must make[, config options])}), held to the
    "plain" mode's (fused attention off) with the floored
    measure below ≤ 1e-3; with a "kernel_remat" mode, it and "kernel"
    (remat off) agree within 1e-6; with an "f64" mode (the plain path in
    f64; LayerNorm statistics, softmax and the losses stay f32 there: the
    port computes them in f32) the distance of each f32 mode from it is
    reported.  With `loss_tol`, every loss key of each "kernel" mode is
    within loss_tol · max(1, |plain's|) of the plain mode's."""
    import copy

    import torch

    from leccr_torch.models.leccr import LECCRModel
    from leccr_torch.ops.attention import set_compute_dtype
    from leccr_torch.train.step import make_train_step

    grads, launches, losses = {}, {}, {}
    for mode, (fused, remat, dtype, want, *options) in modes.items():
        tcfg = copy.deepcopy(cfg)
        set_options(tcfg, options[0] if options else {})
        mc = tcfg.model
        mc.dtype = "float32"
        mc.remat = remat
        mc.dropout = mc.text.hidden_dropout = mc.text.attention_dropout = 0.0
        mc.vision.fused_attention = mc.text.fused_attention = fused
        tcfg.train.schedular.num_warmup_steps = 0
        model = LECCRModel(mc, device="cuda", seed=seed)
        if dtype == torch.float64:
            model.double()
            set_compute_dtype(model, torch.float64)
        step = make_train_step(tcfg, model, total_steps=10000)
        before = step_counts()
        losses[mode] = step(train_batch(cfg, n, width, seed + 3), 0)
        torch.cuda.synchronize()
        launches[mode] = tuple(a - b for a, b in zip(step_counts(), before))
        if launches[mode] != want:
            raise AssertionError(f"{mode}: kernel launches {launches[mode]}, "
                                 f"want {want}")
        grads[mode] = {name: p.grad.detach().clone()
                       for name, p in model.named_parameters()}
        del model, step
        torch.cuda.empty_cache()
    # relative to the parameter's largest gradient, floored at 1e-4 of the
    # model's largest: below that, gradients are ill-conditioned sums
    # (e.g. the last text layer's q/k, where only the CLS row has a
    # gradient) that f32 itself gets only to ~1e-3 against f64, and the
    # key biases' gradients are 0 in exact arithmetic (softmax is
    # shift-invariant) and f32 noise on every path
    ref = "f64" if "f64" in modes else "plain"
    floor = 1e-4 * max(g.abs().max().item() for g in grads[ref].values())

    def rel_errs(a, b):
        return {name: (grads[a][name].double() - g.double()).abs().max()
                .item() / max(g.abs().max().item(), floor)
                for name, g in grads[b].items()}

    checks = {f"{m}_vs_plain": (m, "plain", 1e-3) for m in modes
              if m.startswith("kernel")}
    if "kernel_remat" in modes:
        checks["kernel_remat_vs_kernel"] = ("kernel_remat", "kernel", 1e-6)
    worst = {}
    for check, (a, b, tol) in checks.items():
        rel = rel_errs(a, b)
        name = max(rel, key=rel.get)
        worst[check] = {"max_rel_grad_err": rel[name], "worst_param": name,
                        "tolerance": tol}
        if rel[name] > tol:
            raise AssertionError(f"{check}: gradients differ at {name}: "
                                 f"{rel[name]} > {tol}")
    extra = {}
    if loss_tol is not None:
        plain = losses["plain"]
        extra["max_rel_loss_err"] = {m: max(
            abs(losses[m][key] - plain[key]) / max(1.0, abs(plain[key]))
            for key in plain) for m in modes if m.startswith("kernel")}
        extra["loss_tolerance"] = loss_tol
        if max(extra["max_rel_loss_err"].values()) > loss_tol:
            raise AssertionError(f"losses differ: {extra['max_rel_loss_err']}"
                                 f" > {loss_tol}")
    if "f64" in modes:
        extra["max_rel_grad_err_vs_f64"] = {
            m: max(rel_errs(m, "f64").values()) for m in modes if m != "f64"}
    first = worst[next(iter(worst))]
    emit(phase, dtype="float32", examples=n, tokens=width,
         launches={m: dict(zip(STEP_COUNTERS, c))
                   for m, c in launches.items()},
         params_checked=len(grads["plain"]),
         max_rel_grad_err=first["max_rel_grad_err"],
         worst_param=first["worst_param"], checks=worst, **extra,
         tolerance="max |Δg| / max(max |g|, 1e-4 · the model's largest "
                   "|g|), per parameter",
         total=losses["kernel"]["total"])
    del grads


def train_step_phase(cfg, card_line: str, per_step, phase: str = "train_step",
                     batch: int = 128, width: int = 64, warmup: int = 3,
                     steps: int = 5, seed: int = 0):
    """A train step at bf16 compute with f32 master weights (bench.py:
    279-370's inputs): warm-up steps, then timed steps, then one profiled
    step.  Each step must launch kernels 2-11 exactly `per_step` times.
    Returns the flash launches of the warm-up and timed steps."""
    import torch

    from leccr_torch.models.leccr import LECCRModel
    from leccr_torch.train.step import make_train_step

    cfg.train.schedular.num_warmup_steps = 0  # linear_warmup_decay(1e-5, 10000, 0)
    cfg.train.optimizer.lr = 1e-5
    model = LECCRModel(cfg.model, device="cuda", seed=seed)
    step = make_train_step(cfg, model, total_steps=10000)
    data = train_batch(cfg, batch, width, seed + 5)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    reset_counts()
    t0 = time.perf_counter()
    for i in range(warmup):
        step(data, i)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    history = []
    for i in range(warmup, warmup + steps):
        history.append(step(data, i))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = step_counts()
    want = tuple(n * (warmup + steps) for n in per_step)
    if launches != want:
        raise AssertionError(f"train steps launched kernels {launches}, "
                             f"want {want} ({per_step} a step)")
    tc = tc_counts()  # bf16 at Dh = 64: kernels 2/3 on tensor cores only
    if cfg.model.dtype == "bfloat16" and tc != launches[:2]:
        raise AssertionError(f"kernels 2/3 launched {launches[:2]}, of them "
                             f"{tc} on the tensor-core variant")
    # and kernels 4, 6, 7, 8 and 5 on their wgmma variant only
    wgmma, streamed = wgmma_counts(), tuple(launches[i] for i in WGMMA_OF)
    if cfg.model.dtype == "bfloat16" and wgmma != streamed:
        raise AssertionError(f"kernels 4, 6, 7, 8, 5 launched {streamed}, of "
                             f"them {wgmma} on the wgmma variant")
    if not all(math.isfinite(v) for losses in history
               for v in losses.values()):
        raise AssertionError(f"non-finite losses {history}")
    unmoved = [n for n, p in model.named_parameters()
               if torch.equal(p.detach(), start[n])]
    if unmoved:
        raise AssertionError(f"params that did not move: {unmoved[:5]}")
    emit(phase, card=card_line, batch=batch, tokens=width,
         dtype=cfg.model.dtype, image_res=cfg.model.vision.image_res,
         vision=cfg.model.vision.variant, text=cfg.model.text.kind,
         remat=cfg.model.remat, steps=steps, warmup_steps=warmup,
         warmup_s=warm_s, ms_per_step=wall / steps * 1e3,
         pairs_per_s=batch * steps / wall,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         launches=dict(zip(STEP_COUNTERS, launches)),
         launches_per_step=dict(zip(STEP_COUNTERS, per_step)),
         tc_launches=dict(zip(TC_COUNTERS, tc)),
         wgmma_launches=dict(zip(WGMMA_COUNTERS, wgmma)),
         params=sum(p.numel() for p in model.parameters()),
         losses_first=history[0], losses_last=history[-1])
    del start
    profile_step(step, data, warmup + steps, wall / steps * 1e3,
                 phase + "_profile")
    del model, step
    torch.cuda.empty_cache()
    return launches


# the __global__ functions of kernels 2/3, scalar and tensor-core variants
SINGLE_BLOCK_KERNELS = {"fwd_kernel": "single_fwd",
                        "fwd_tc_kernel": "single_fwd",
                        "bwd_dq_kernel": "single_bwd",
                        "bwd_dkv_kernel": "single_bwd",
                        "bwd_dq_tc_kernel": "single_bwd",
                        "bwd_dkv_tc_kernel": "single_bwd"}
# the __global__ functions of kernels 4, 5, 6, 7 and 8's wgmma variant
WGMMA_KERNELS = {"chunk_fwd_wgmma_kernel": "chunked",
                 "chunk_bwd_dq_wgmma_kernel": "chunked",
                 "chunk_bwd_dkv_wgmma_kernel": "chunked",
                 "tiled_fwd_wgmma_kernel": "tiled_fwd",
                 "tiled_dq_wgmma_kernel": "tiled_dq",
                 "tiled_dkv_wgmma_kernel": "tiled_dkv"}
_KERNEL_NAME = re.compile(r"(?:^|::|\s)(\w+)[<(]")
_PTXAS_FN = re.compile(r"(?:Compiling entry function '|Function properties "
                       r"for )([\w$]+)")
_PTXAS_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")


def ptxas_report(log: str, names) -> dict:
    """Registers and spill bytes that ptxas -v reports in `log` for each
    kernel of `names` (found by its name inside the mangled one): {name:
    {"registers": n, "spill_stores": bytes, "spill_loads": bytes}}, None
    for a kernel the log does not show."""
    found, current = {}, None
    for line in log.splitlines():
        match = _PTXAS_FN.search(line)
        if match:
            current = found.setdefault(match.group(1), {})
            continue
        spill, regs = _PTXAS_SPILL.search(line), _PTXAS_REGS.search(line)
        if current is not None and spill:
            current["spill_stores"] = int(spill.group(1))
            current["spill_loads"] = int(spill.group(2))
        if current is not None and regs:
            current["registers"] = int(regs.group(1))
    return {name: next((v for k, v in found.items() if name in k), None)
            for name in names}


def spill_check(build_module, libs, names) -> dict:
    """ptxas_report of `names` in the libraries `libs` that this run
    compiled; raises if one of them spills or is missing, when all of
    `libs` were compiled here."""
    built = [n for n in libs if build_module.build_info[n][1]]
    report = ptxas_report(
        "\n".join(build_module.build_info[n][1] for n in built), names)
    if len(built) == len(libs) and not all(
            r is not None and r["spill_stores"] == r["spill_loads"] == 0
            for r in report.values()):
        raise AssertionError(f"a kernel spills or is missing from ptxas' "
                             f"report: {report}")
    return report


def flash_kernel_of(key: str):
    """The family of a profiled kernel name (e.g. "void (anonymous
    namespace)::fwd_tc_kernel((anonymous namespace)::Params)"), from its
    function's own name: "single_fwd" (kernel 2) and "single_bwd" (kernel
    3's two passes), in either variant; "chunked" (kernels 4/5,
    chunk_*); "tiled_fwd", "tiled_dq", "tiled_dkv" (kernels 6, 7, 8, each
    in either variant); "infonce" (kernels 9-11); None for every other
    kernel."""
    match = _KERNEL_NAME.search(key)
    if match is None:
        return None
    fn = match.group(1)
    if fn in SINGLE_BLOCK_KERNELS:
        return SINGLE_BLOCK_KERNELS[fn]
    if fn in WGMMA_KERNELS:
        return WGMMA_KERNELS[fn]
    if fn.startswith("chunk_"):
        return "chunked"
    for n in ("fwd", "dq", "dkv"):
        if fn.startswith(f"tiled_{n}_"):
            return f"tiled_{n}"
    if fn.startswith("infonce_"):
        return "infonce"
    return None


def profile_step(step, data, step_no: int, step_ms: float,
                 phase: str = "train_step_profile", top: int = 12) -> None:
    """One more train step under torch.profiler: device time by kernel, the
    flash kernels' share (kernels 2-8; the single-block ones 2 and 3, the
    chunked ones 4/5 and the tiled ones 6, 7, 8 also alone; see
    `flash_kernel_of`), the InfoNCE kernels' (9-11) and the device's busy
    share of an unprofiled step (`step_ms`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(data, step_no)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if str(getattr(e, "device_type", "")).endswith("CUDA")
              and not getattr(e, "is_user_annotation", False)]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    families = {}
    for e in events:
        family = flash_kernel_of(e.key)
        families[family] = (families.get(family, 0.0)
                             + e.self_device_time_total / 1e3)
    single_ms = {n: families.get(f"single_{n}", 0.0) for n in ("fwd", "bwd")}
    chunk_ms = families.get("chunked", 0.0)
    tiled_ms = {n: families.get(f"tiled_{n}", 0.0)
                for n in ("fwd", "dq", "dkv")}
    flash_ms = sum(single_ms.values()) + chunk_ms + sum(tiled_ms.values())
    infonce_ms = families.get("infonce", 0.0)
    if device_ms <= 0:
        raise AssertionError("the profiler saw no device time")
    rows = sorted(events, key=lambda e: -e.self_device_time_total)[:top]
    emit(phase, profiled_wall_ms=wall_ms,
         unprofiled_step_ms=step_ms, device_ms=device_ms,
         device_busy_share=device_ms / step_ms, flash_ms=flash_ms,
         flash_share_of_device=flash_ms / device_ms,
         single_flash_ms=single_ms,
         single_share_of_device={n: t / device_ms
                                 for n, t in single_ms.items()},
         chunked_flash_ms=chunk_ms,
         chunked_share_of_device=chunk_ms / device_ms,
         tiled_flash_ms=tiled_ms,
         tiled_share_of_device={n: t / device_ms
                                for n, t in tiled_ms.items()},
         infonce_ms=infonce_ms, infonce_share_of_device=infonce_ms / device_ms,
         top=[{"name": e.key[:80], "ms": e.self_device_time_total / 1e3,
               "calls": e.count} for e in rows])


def slice_config():
    """The long-sequence slice's configuration: configs/scale_vitl_32k.yaml
    (ViT-L/14 @336 + XLM-R-large, remat, ring_fused negatives) with flash
    attention in both towers and one card (parallel data = model = 1)."""
    from leccr_torch.config import load_config

    cfg = load_config(str(ROOT / "configs" / "scale_vitl_32k.yaml"))
    cfg.model.vision.fused_attention = cfg.model.text.fused_attention = True
    cfg.parallel.data = cfg.parallel.model = 1
    return cfg


def hires_config():
    """The high-resolution slice's configuration: slice_config() with the
    vision tower at 728² (ViT-L/14: 52 x 52 patches + CLS = 2705 tokens,
    past fits_chunked in bf16 and f32: kernels 6-8)."""
    cfg = slice_config()
    cfg.model.vision.image_res = HIRES_RES
    return cfg


# the large-batch slice's cuts of configs/multi30k_all.yaml (the warmup is
# cut to 0 in train_step_phase); the gradient check takes the same path at
# 16 examples in 4 microbatches and blocks of 8 rows
LARGE_BATCH_OPTIONS = {"parallel.negatives": "fused",
                       "train.batch_size_train": LARGE_BATCH,
                       "train.grad_cache_microbatches": LARGE_MICROBATCHES,
                       "parallel.stream_loss_block_rows": LARGE_STREAM_ROWS,
                       "parallel.data": 1}
LARGE_CHECK_OPTIONS = {"parallel.negatives": "fused",
                       "train.grad_cache_microbatches": 4,
                       "parallel.stream_loss_block_rows": 8}
LARGE_CHECK_LAUNCHES = (36 * 4 * 2, 24 * 4, 0, 0, 0, 0, 0, 6, 6, 6)


def large_batch_config():
    """The large-batch slice's configuration: configs/multi30k_all.yaml's
    model at full width with `negatives: fused`, a 4096-example batch in
    16 GradCache microbatches, the dstl and caption-vision losses streamed
    in 256-row blocks, one card."""
    from leccr_torch.config import load_config

    cfg = load_config(str(ROOT / "configs" / "multi30k_all.yaml"))
    set_options(cfg, LARGE_BATCH_OPTIONS)
    return cfg


def model_check_phase(cfg, seed: int = 0, n: int = 4):
    """Full-width model in f32: kernel path vs plain attention path."""
    import copy

    import torch

    from leccr_torch.data.images import normalize_images
    from leccr_torch.models.leccr import LECCRModel
    from leccr_torch.ops.fused_cross_attention import fused_cross_attention

    mcfg = copy.deepcopy(cfg.model)
    mcfg.dtype = "float32"
    model = LECCRModel(mcfg, device="cuda", seed=seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    res, length = mcfg.vision.image_res, cfg.data.max_tokens
    mask = (torch.arange(length, device="cuda")[None, :]
            < torch.tensor([[length], [150], [37], [5]], device="cuda")
            ).int()[:n]
    batch = {
        "vision": normalize_images(torch.randint(
            0, 256, (n, res, res, 3), dtype=torch.uint8, device="cuda",
            generator=g)),
        "caption_ids": torch.randint(1, mcfg.text.vocab_size, (n, length),
                                     device="cuda", generator=g) * mask,
        "caption_mask": mask,
    }
    mcfg.fused_eval_attention = True
    before = fused_cross_attention.launches
    kernel = model.embed_images(batch)
    launches = fused_cross_attention.launches - before
    mcfg.fused_eval_attention = False
    plain = model.embed_images(batch)
    plain_launches = fused_cross_attention.launches - before - launches
    if launches != launches_per_batch(cfg) or plain_launches != 0:
        raise AssertionError(f"kernel path launched {launches} times, "
                             f"plain path {plain_launches}")
    err = max((kernel[key] - plain[key]).abs().max().item()
              for key in ("feat", "slots"))
    if not err <= 1e-4:
        raise AssertionError(f"model with the kernel differs from the plain "
                             f"path by {err}")
    emit("model_check", dtype="float32", images=n, kernel_launches=launches,
         max_abs_err=err, tolerance="atol 1e-4")
    del model
    torch.cuda.empty_cache()


def serve_phase(cfg, n_images: int = 256, seed: int = 0):
    import numpy as np
    import torch

    from leccr_torch.data.tokenizers import write_tiny_wordpiece_vocab
    from leccr_torch.ops._build import BUILD_DIR
    from leccr_torch.ops.fused_cross_attention import fused_cross_attention
    from leccr_torch.serve import Embedder

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    vocab = BUILD_DIR / "smoke_vocab.txt"
    write_tiny_wordpiece_vocab(str(vocab), WORDS)
    cfg.data.text_vocab = str(vocab)
    t0 = time.perf_counter()
    emb = Embedder.from_config(cfg, seed=seed, device="cuda", batch_size=64)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    model = emb.model
    n_params = sum(p.numel() for p in model.parameters())

    rs = np.random.RandomState(seed)
    res = cfg.model.vision.image_res
    g = torch.Generator(device="cuda").manual_seed(seed)
    images = torch.randint(0, 256, (n_images, res, res, 3), dtype=torch.uint8,
                           device="cuda", generator=g)

    def sentence(lo, hi):
        return " ".join(rs.choice(WORDS, rs.randint(lo, hi)))

    captions = [sentence(3, 260) for _ in range(n_images)]  # some truncated
    queries = [sentence(2, 12) for _ in range(5)]
    corpus = [sentence(2, 20) for _ in range(300)]

    reset_counts()
    t0 = time.perf_counter()
    index = emb.build_image_index(images, captions)
    torch.cuda.synchronize()
    index_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    hits = emb.search_texts(queries, index, k=10)
    hits_mm = emb.search_texts(queries, index, k=10, fusion="minmax")
    hits_img = emb.search_images(index, corpus, k=5)
    search_s = time.perf_counter() - t0
    launches = fused_cross_attention.launches
    by_body = kernel1_counts("serving")
    if any(step_counts()):
        raise AssertionError("serving launched the training kernels")

    n_batches = math.ceil(n_images / emb.batch_size)
    if launches != launches_per_batch(cfg) * n_batches:
        raise AssertionError(
            f"kernel launched {launches} times for {n_batches} image "
            f"batches (want {launches_per_batch(cfg)} each)")
    feats, slots = index.feats, index.slots
    if feats.shape != (n_images, cfg.model.embed_dim) or slots.shape != (
            n_images, cfg.model.num_queries, cfg.model.embed_dim):
        raise AssertionError(f"index shapes {feats.shape} {slots.shape}")
    if not (torch.isfinite(feats).all() and torch.isfinite(slots).all()):
        raise AssertionError("non-finite index")
    norm_err = (feats.norm(dim=-1) - 1).abs().max().item()
    if norm_err > 1e-2:  # normalized in bf16, then cast to f32
        raise AssertionError(f"index rows are not unit-norm: {norm_err}")
    texts = torch.from_numpy(emb.embed_texts(corpus[:64]))
    text_norm_err = (texts.norm(dim=-1) - 1).abs().max().item()
    if not torch.isfinite(texts).all() or text_norm_err > 1e-2:
        raise AssertionError(f"text embeddings off: {text_norm_err}")
    ids = set(index.ids)
    for rows, k in ((hits, 10), (hits_mm, 10)):
        for row in rows:
            scores = [s for _, s in row]
            if (len(row) != k or not all(i in ids for i, _ in row)
                    or scores != sorted(scores, reverse=True)
                    or not all(math.isfinite(s) for s in scores)):
                raise AssertionError(f"bad search result {row}")
    if len(hits_img) != n_images or any(len(r) != 5 for r in hits_img):
        raise AssertionError("bad search_images result")
    emit("serve", params=n_params, init_s=init_s, images=n_images,
         image_batches=n_batches, index_s=index_s,
         search_requests=3, search_s=search_s, kernel_launches=launches,
         kernel_launches_by_body=by_body,
         max_unit_norm_err=norm_err, top_hit=hits[0][0],
         top_hit_minmax=hits_mm[0][0])
    return emb, by_body


def eval_phase(emb, card_line: str, n_img: int = 1000, n_txt: int = 5000,
               length: int = 200, img_bs: int = 50, txt_bs: int = 256,
               seed: int = 0):
    import numpy as np
    import torch

    from leccr_torch.data.images import normalize_images
    from leccr_torch.eval.retrieval import (
        itm_metrics_from_ranks,
        retrieval_ranks,
    )
    from leccr_torch.ops.fused_cross_attention import fused_cross_attention

    model, cfg = emb.model, emb.cfg
    res, vocab = cfg.model.vision.image_res, cfg.model.text.vocab_size
    g = torch.Generator(device="cuda").manual_seed(seed + 2)
    images = torch.randint(0, 256, (n_img, res, res, 3), dtype=torch.uint8,
                           device="cuda", generator=g)
    cap_ids = torch.randint(1, vocab, (n_img, length), device="cuda",
                            generator=g)
    text_ids = torch.randint(1, vocab, (n_txt, length), device="cuda",
                             generator=g)
    cap_mask = torch.ones_like(cap_ids, dtype=torch.int32)
    text_mask = torch.ones_like(text_ids, dtype=torch.int32)
    txt2img = np.arange(n_txt) % n_img
    img2txt = {i: [t for t in range(i, n_txt, n_img)][:8]
               for i in range(n_img)}

    def run():
        times = {}
        t0 = time.perf_counter()
        txt = torch.cat([model.embed_texts(text_ids[i:i + txt_bs],
                                           text_mask[i:i + txt_bs])
                         for i in range(0, n_txt, txt_bs)])
        torch.cuda.synchronize()
        times["embed_texts_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        img = torch.cat([model.embed_images({
            "vision": normalize_images(images[i:i + img_bs]),
            "caption_ids": cap_ids[i:i + img_bs],
            "caption_mask": cap_mask[i:i + img_bs]})["feat"]
            for i in range(0, n_img, img_bs)])
        torch.cuda.synchronize()
        times["embed_images_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ranks = retrieval_ranks(img, txt, txt2img, img2txt)
        times["ranks_s"] = time.perf_counter() - t0
        return img, txt, ranks, times

    t0 = time.perf_counter()
    run()  # warm-up: cuBLAS handles, allocator, kernel library
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    img, txt, (i2t, t2i), times = run()
    wall = time.perf_counter() - t0
    launches = fused_cross_attention.launches
    by_body = kernel1_counts("the eval")
    if any(step_counts()):
        raise AssertionError("the eval launched the training kernels")
    if launches != launches_per_batch(cfg) * math.ceil(n_img / img_bs):
        raise AssertionError(f"eval launched the kernel {launches} times")

    # the ranks against a dense count over the same block products
    block = 256
    pad = (-n_img) % block
    padded = torch.nn.functional.pad(img, (0, 0, 0, pad))
    s = torch.cat([padded[r:r + block] @ txt.T
                   for r in range(0, n_img + pad, block)])[:n_img]
    s = s.cpu().numpy()
    cols = np.arange(n_txt)
    g_t = s[txt2img, cols]
    want_t2i = ((s > g_t) | ((s == g_t)
                             & (np.arange(n_img)[:, None] > txt2img))).sum(0)
    gt = np.array([img2txt[i] for i in range(n_img)])
    g_i = np.take_along_axis(s, gt, axis=1)[:, :, None]
    want_i2t = ((s[:, None, :] > g_i) | ((s[:, None, :] == g_i)
                                         & (cols > gt[:, :, None]))
                ).sum(-1).min(1)
    if not (np.array_equal(i2t, want_i2t) and np.array_equal(t2i, want_t2i)):
        raise AssertionError("streaming ranks differ from the dense count")
    metrics = itm_metrics_from_ranks(i2t, t2i)
    if len(metrics) != 13 or not all(math.isfinite(v)
                                     for v in metrics.values()):
        raise AssertionError(f"bad metrics {metrics}")
    emit("eval", card=card_line, images=n_img, texts=n_txt, tokens=length,
         image_batch=img_bs, text_batch=txt_bs, wall_s=wall,
         pairs_per_s=n_img * n_txt / wall, warmup_s=warm_s, **times,
         kernel_launches=launches, kernel_launches_by_body=by_body,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         metrics=metrics)
    return by_body


# the fit phase's cuts of configs/multi30k_all.yaml: synthetic data (64
# images x 5 captions = 320 pairs: 2 steps an epoch at bs128, 64 eval
# images), 2 epochs, one checkpoint kept, a mid-epoch snapshot at step 3
FIT_OPTIONS = {"data.dataset": "synthetic", "data.synthetic_size": 64,
               "data.synthetic_eval_images": 64,
               "train.schedular.epochs": 2, "train.keep_checkpoints": 1,
               "train.checkpoint_every_steps": 3}


def state_equal(a, b) -> bool:
    """Two state trees (dicts, lists, tensors, scalars) bit for bit."""
    import torch

    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and a.shape == b.shape and torch.equal(a.cpu(), b.cpu()))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(state_equal(a[k], b[k])
                                            for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(state_equal, a, b))
    return a == b


def fit_phase(card_line: str, seed: int = 0):
    """`Trainer(cfg).fit()` on the card: configs/multi30k_all.yaml at full
    width with FIT_OPTIONS, from files on disk (the synthetic set written
    in a temporary output dir, removed after).  Kernels 2/3 must launch
    FLAGSHIP_STEP_LAUNCHES a step (all on the tensor-core variant) and
    kernel 1 launches_per_batch() an embed_images batch (its small bodies
    only), counted over every step and eval batch of the run; every step's
    losses finite, sumr finite, log.txt's records, best.json, and the last
    checkpoint restored into a second Trainer(resume) bit for bit (model,
    optimizer, step).  Prints host-fed ms/step (the median of the steps
    after each epoch's first, each ending in the loss read-back) and
    pairs/s, the loader's wait per step, eval s per split (epoch 0
    uncached, epoch 1 from the device cache), checkpoint save s and
    bytes, peak memory.  Returns (kernel 2/3 launches, kernel 1 counts)."""
    import copy
    import shutil
    import statistics
    import tempfile

    import torch

    from leccr_torch.config import load_config
    from leccr_torch.ops.fused_cross_attention import fused_cross_attention
    from leccr_torch.train.trainer import Trainer

    out = Path(tempfile.mkdtemp(prefix="chip_smoke_fit_"))
    try:
        cfg = load_config(str(ROOT / "configs" / "multi30k_all.yaml"))
        set_options(cfg, FIT_OPTIONS)
        cfg.train.seed = seed
        cfg.output_dir = str(out)
        resume_cfg = copy.deepcopy(cfg)
        resume_cfg.train.resume = True
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tr = Trainer(cfg)
        init_s = time.perf_counter() - t0

        losses, evals, saves, writes = [], [], [], []
        run, evaluate = tr.state.train_step.run, tr.evaluate
        save, write = tr.ckpt.save, tr.ckpt._write_step

        def run_noted(batch, step_no):
            values = run(batch, step_no)
            losses.append(values)
            return values

        def evaluate_timed(dataset):
            t = time.perf_counter()
            metrics = evaluate(dataset)
            torch.cuda.synchronize()
            evals.append(time.perf_counter() - t)
            return metrics

        def save_timed(*args, **kwargs):
            t = time.perf_counter()
            save(*args, **kwargs)
            saves.append(time.perf_counter() - t)

        def write_timed(*args):
            t = time.perf_counter()
            write(*args)
            writes.append(time.perf_counter() - t)

        tr.state.train_step.run = run_noted
        tr.evaluate = evaluate_timed
        tr.ckpt.save, tr.ckpt._write_step = save_timed, write_timed

        reset_counts()
        t0 = time.perf_counter()
        stats = tr.fit()
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = step_counts()
        tc = tc_counts()
        by_body = kernel1_counts("the fit's evals")

        steps = tr.state.step
        epochs = cfg.train.schedular.epochs
        bs_test = cfg.train.batch_size_test
        eval_batches = epochs * sum(
            math.ceil(len(ds) / bs_test)
            for split in (tr.val_ds, tr.test_ds) for ds in split.values())
        want = tuple(n * steps for n in FLAGSHIP_STEP_LAUNCHES)
        if steps != epochs * tr.steps_per_epoch or launches != want:
            raise AssertionError(f"the fit took {steps} steps and launched "
                                 f"kernels 2-11 {launches}, want {want}")
        if tc != launches[:2]:
            raise AssertionError(f"kernels 2/3 launched {launches[:2]}, of "
                                 f"them {tc} on the tensor-core variant")
        if by_body["all"] != launches_per_batch(cfg) * eval_batches:
            raise AssertionError(f"kernel 1 launched {by_body} for "
                                 f"{eval_batches} embed_images batches")
        values = torch.stack(losses)
        if len(losses) != steps or not torch.isfinite(values).all():
            raise AssertionError(f"losses of {len(losses)} steps: {values}")
        records = [json.loads(line) for line in
                   (out / "log.txt").read_text().splitlines()]
        sumr = [r["de_test_sumr_sum"] for r in records[:-1]]
        if ([r.get("epoch") for r in records] != list(range(epochs)) + [None]
                or not all(math.isfinite(v) for v in sumr)
                or not math.isfinite(stats["de_test_sumr_sum"])):
            raise AssertionError(f"log.txt records {records}")
        best = json.loads((out / "checkpoints" / "best.json").read_text())
        files = sorted((out / "checkpoints").glob("step_*.pt"))
        if [f.name for f in files] != [f"step_{steps:08d}.pt"]:
            raise AssertionError(f"checkpoints kept: {files}")

        t0 = time.perf_counter()
        tr2 = Trainer(resume_cfg)
        resumed = tr2.resume()
        restore_s = time.perf_counter() - t0
        if not (resumed == (epochs, 0) and tr2.state.step == steps
                and state_equal(tr2.state.model.state_dict(),
                                 tr.state.model.state_dict())
                and state_equal(tr2.state.optimizer.state_dict(),
                                 tr.state.optimizer.state_dict())):
            raise AssertionError("the checkpoint did not restore bit for "
                                 "bit")
        del tr2

        # host-fed step time: each epoch's steps after its first (from
        # asking the loader for its batch to asking for the next, or to
        # the epoch's end after the loss read-back)
        later = [s for t in tr.timing for s in t["step_s"][1:]]
        step_ms = statistics.median(later) * 1e3
        batch = cfg.train.batch_size_train
        emit("fit", card=card_line, config="configs/multi30k_all.yaml",
             options=FIT_OPTIONS, batch=batch, steps=steps,
             steps_per_epoch=tr.steps_per_epoch, epochs=epochs,
             eval_batches=eval_batches, init_s=init_s, fit_s=fit_s,
             host_fed_ms_per_step=step_ms,
             host_fed_pairs_per_s=batch / step_ms * 1e3,
             step_s=[t["step_s"] for t in tr.timing],
             loader_wait_s=[t["wait_s"] for t in tr.timing],
             loader_wait_ms_median=statistics.median(
                 w for t in tr.timing for w in t["wait_s"]) * 1e3,
             eval_s=evals, eval_s_uncached=evals[:2],
             eval_s_cached=evals[2:4],
             eval_cache_mb=tr._eval_cache_bytes / 2 ** 20,
             save_caller_s=saves, save_write_s=writes,
             checkpoint_bytes=files[0].stat().st_size,
             restore_s=restore_s, peak_mem_gb=(
                 torch.cuda.max_memory_allocated() / 1e9),
             launches=dict(zip(STEP_COUNTERS, launches)),
             tc_launches=dict(zip(TC_COUNTERS, tc)),
             kernel1_launches=by_body, best=best,
             losses_first=values[0].tolist(), losses_last=values[-1].tolist(),
             sumr_sum=sumr,
             train_loss_itc_vs=[r["train_loss_itc_vs"]
                                for r in records[:-1]],
             fused_cross_attention_launches=fused_cross_attention.launches)
        del tr
        torch.cuda.empty_cache()
        return launches, by_body
    finally:
        shutil.rmtree(out, ignore_errors=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from leccr_torch.config import load_config
    from leccr_torch.models.clip import CLIP_VARIANTS
    from leccr_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card_line = card()
    print(card_line, flush=True)
    emit("device", card=card_line, torch=torch.__version__,
         cuda=torch.version.cuda, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())
    t0 = time.perf_counter()
    _build.build(*KERNEL_LIBS)  # one nvcc per source, side by side
    # the wgmma kernels (4-8) and the InfoNCE kernels (9-11 and their
    # merges) in this run's ptxas report: none may spill (a library found
    # on disk was not compiled, and has no report)
    wgmma_ptxas = spill_check(
        _build, ("flash_chunked_attention", "flash_tiled_attention"),
        WGMMA_KERNELS)
    infonce_ptxas = spill_check(_build, ("fused_infonce",), INFONCE_KERNELS)
    emit("build", kernels=list(KERNEL_LIBS),
         wall_s=time.perf_counter() - t0,
         nvcc_s={n: _build.build_info[n][0] for n in KERNEL_LIBS},
         ptxas={n: sorted({ln.split(":", 1)[1].strip() for ln in
                           _build.build_info[n][1].splitlines()
                           if "ptxas info    : Used" in ln})
                for n in KERNEL_LIBS},
         wgmma_ptxas=wgmma_ptxas, infonce_ptxas=infonce_ptxas)

    shapes = kernel_phase()
    flash = flash_phase()
    chunked = chunked_phase()
    tiled = tiled_phase()
    infonce = infonce_phase()
    cfg = load_config(str(ROOT / "configs" / "multi30k_all.yaml"))
    loss_phase(cfg)
    model_check_phase(cfg)
    f32, f64 = torch.float32, torch.float64
    none = (0,) * len(STEP_COUNTERS)
    train_grad_check_phase(cfg, {
        "kernel": (True, False, f32, FLAGSHIP_STEP_LAUNCHES),
        "plain": (False, False, f32, none), "f64": (False, False, f64, none)})
    train_grad_check_phase(slice_config(), {
        "kernel": (True, False, f32, SLICE_STEP_LAUNCHES[False]),
        "kernel_remat": (True, True, f32, SLICE_STEP_LAUNCHES[True]),
        "plain": (False, False, f32, none)}, phase="slice_grad_check")
    # the high-resolution slice through kernels 6-8 (f32 at 2705 tokens is
    # tiled); the plain path recomputes its blocks (remat) to hold one
    # layer's [2, 16, 2705, 2705] f32 scores at a time
    train_grad_check_phase(hires_config(), {
        "kernel": (True, False, f32, HIRES_STEP_LAUNCHES[False]),
        "kernel_remat": (True, True, f32, HIRES_STEP_LAUNCHES[True]),
        "plain": (False, True, f32, none)}, phase="hires_grad_check", n=2)
    # GradCache + fused InfoNCE + streaming against the monolithic dense
    # step, both through the flash kernels
    train_grad_check_phase(cfg, {
        "kernel": (True, False, f32, LARGE_CHECK_LAUNCHES,
                   LARGE_CHECK_OPTIONS),
        "plain": (True, False, f32, FLAGSHIP_STEP_LAUNCHES)},
        phase="large_batch_grad_check", n=16, loss_tol=1e-5)
    # the flagship step launches none of kernels 4/5 and 9-11
    train_launches = train_step_phase(
        load_config(str(ROOT / "configs" / "multi30k_all.yaml")), card_line,
        FLAGSHIP_STEP_LAUNCHES)
    slice_launches = train_step_phase(
        slice_config(), card_line, SLICE_STEP_LAUNCHES[True],
        phase="slice_train_step", batch=32)
    no_remat = slice_config()
    no_remat.model.remat = False  # what remat costs, in the same call
    train_step_phase(no_remat, card_line, SLICE_STEP_LAUNCHES[False],
                     phase="slice_train_step_no_remat", batch=32, warmup=2,
                     steps=3)
    hires_launches = train_step_phase(
        hires_config(), card_line, HIRES_STEP_LAUNCHES[True],
        phase="hires_train_step", batch=HIRES_BATCH, warmup=2, steps=3)
    large_launches = train_step_phase(
        large_batch_config(), card_line, LARGE_STEP_LAUNCHES,
        phase="large_batch_step", batch=LARGE_BATCH, warmup=1, steps=2)
    emb, serve_launches = serve_phase(cfg)
    eval_launches = eval_phase(emb, card_line)
    del emb
    fit_launches, fit_kernel1 = fit_phase(card_line)

    def path_sum(key):  # bf16 at B=64: one embed_images batch, 7 launches
        return sum(PATH_LAUNCHES[(r["lq"], r["lk"])] * r[key] for r in bf16)

    bf16 = [r for r in shapes if r["dtype"] == "bfloat16"]
    vision_layers = (cfg.model.vision.depth
                     or CLIP_VARIANTS[cfg.model.vision.variant].vision_layers)
    text_layers = cfg.model.text.num_layers
    per_step = {"vision": vision_layers, "text": text_layers,
                "caption": text_layers}

    def flash_entry(name, line, direction, launches, slice_launches,
                    hires_launches, large_launches, fit_launches, errs):
        rows = [r for r in flash if r["direction"] == direction
                and r["dtype"] == "bfloat16" and r["shape"] in per_step]

        def step_sum(key):  # bf16, the launches of one bs128 train step
            return sum(per_step[r["shape"]] * r[key] for r in rows)

        return {
            "name": name, "route": "cuda",
            "source": "leccr_torch/csrc/flash_tower_attention.cu",
            "replaces": f"leccr_tpu/ops/flash_attention.py:{line}",
            "variant": sorted({r["variant"] for r in rows}),
            "launches": launches,
            "launches_slice_step": slice_launches,
            "launches_hires_step": hires_launches,
            "launches_large_batch_step": large_launches,
            "launches_fit": fit_launches,
            "max_abs_err": max(r["max_abs_err"][e] for r in flash
                               if r["direction"] == direction for e in errs),
            "check": "ok",
            "timed_as": "bf16, the launches of one bs128 train step: " + ", ".join(
                f"{per_step[r['shape']]}x {r['shape']} [{r['b']},{r['h']},"
                f"{r['l']},{r['dh']}]" for r in rows) + ", L2 flushed",
            "ms": step_sum("ms"), "plain_ms": step_sum("plain_ms"),
            "bound_ms": step_sum("bound_ms"),
            "bound_by": ("bytes" if all(r["bound_by"] == "bytes"
                                        for r in rows) else "operations"),
            "library_ms": step_sum("library_ms"),
            "library": rows[0]["library"],
            "shapes": [r for r in flash if r["direction"] == direction],
        }

    def chunk_entry(name, line, direction, launches, per_step_n, errs):
        r = next(r for r in chunked if r["direction"] == direction
                 and r["dtype"] == "bfloat16" and r["shape"] == "vit-l")
        # train_step_phase held every bf16 launch of kernels 4 and 5 to the
        # wgmma variant
        fwd = direction == "fwd"
        return {
            "name": name, "route": "cuda",
            "source": ("leccr_torch/csrc/flash_fwd_wgmma.cuh" if fwd else
                       "leccr_torch/csrc/flash_bwd_wgmma.cuh"),
            "replaces": f"leccr_tpu/ops/flash_attention.py:{line}",
            "launches": launches, "variant": r["variant"],
            "launches_wgmma": launches,
            **({} if fwd else {"schedule": "persistent"}),
            "max_abs_err": max(x["max_abs_err"][e] for x in chunked
                               if x["direction"] == direction for e in errs),
            "check": "ok",
            "timed_as": (f"bf16, the launches of one slice train step (bs32, "
                         f"remat): {per_step_n}x vit-l [{r['b']},{r['h']},"
                         f"{r['l']},{r['dh']}], L2 flushed"),
            **{key: per_step_n * r[key] for key in (
                "ms", "plain_ms", "bound_ms", "library_ms")},
            "bound_by": r["bound_by"], "library": r["library"],
            "shapes": [x for x in chunked if x["direction"] == direction
                       or (not fwd and x["direction"] == "fwd+bwd")],
        }

    def tiled_entry(name, line, which, counter):
        r = tiled["timed"][which]
        index = STEP_COUNTERS.index(counter)
        per_step_n = HIRES_STEP_LAUNCHES[True][index]
        errs = {"fwd": ("out", "lse"), "dq": ("dq", "delta"),
                "dkv": ("dk", "dv")}[which]
        # train_step_phase held every launch of 6-8 to the wgmma variant
        variant = {"variant": "wgmma", "launches_wgmma": hires_launches[index]}
        return {
            "name": name, "route": "cuda",
            "source": ("leccr_torch/csrc/flash_fwd_wgmma.cuh"
                       if which == "fwd" else
                       "leccr_torch/csrc/flash_bwd_wgmma.cuh"),
            "replaces": f"leccr_tpu/ops/flash_attention.py:{line}",
            "launches": hires_launches[index], **variant,
            "max_abs_err": max(c["max_abs_err"][e] for c in tiled["checks"]
                               for e in errs),
            "check": "ok",
            "timed_as": (f"bf16, the launches of one high-resolution step "
                         f"(bs{HIRES_BATCH}, remat): {per_step_n}x "
                         f"[{HIRES_BATCH},16,{HIRES_TOKENS},64], L2 flushed"),
            **{key: None if r.get(key) is None else per_step_n * r[key]
               for key in ("ms", "plain_ms", "bound_ms", "library_ms",
                           "chunked_ms", "pair_ms")},
            "schedule": r.get("schedule"),
            "schedules_ms": r.get("schedules_ms"),
            "bound_by": r["bound_by"], "library": r["library"],
            "chunked": r["chunked"], "per_launch": r,
            "shapes": tiled["checks"],
        }

    def infonce_entry(name, line, kernel, launches, errs):
        r = next(r for r in infonce if r["shape"] == "path")
        per_step = LARGE_STEP_LAUNCHES[STEP_COUNTERS.index(
            f"{kernel}_launches")]
        return {
            "name": name, "route": "cuda",
            "source": "leccr_torch/csrc/fused_infonce.cu",
            "replaces": f"leccr_tpu/ops/infonce.py:{line}",
            "launches": launches,
            "max_abs_err": max(x["errors"]["abs"][e] for x in infonce
                               for e in errs),
            "check": "ok",
            "timed_as": (f"f32, the launches of one large-batch step: "
                         f"{per_step}x [{r['m']},{r['e']}] x [{r['n']},"
                         f"{r['e']}], L2 flushed"),
            **{key: per_step * r[kernel][key]
               for key in ("ms", "plain_ms", "bound_ms")},
            "bound_by": r[kernel]["bound_by"],
            "library_ms": None,
            "library": "none: no single PyTorch call computes it",
            "composition_ms": per_step * r[kernel]["composition_ms"],
            "composition": r["composition"],
            "shapes": [{"shape": x["shape"], "m": x["m"], "n": x["n"],
                        "ids": x["ids"], "errors": x["errors"], **x[kernel]}
                       for x in infonce],
        }

    print(json.dumps({"kernels": [{
        "name": "fused_cross_attention",
        "route": "cuda",
        "source": "leccr_torch/csrc/fused_cross_attention.cu",
        "replaces": "leccr_tpu/ops/pallas_attention.py:26",
        "launches": serve_launches["all"] + eval_launches["all"],
        "launches_serve": serve_launches,
        "launches_eval": eval_launches,
        "launches_fit": fit_kernel1,
        "bodies": sorted({r["body"] for r in bf16}),
        "max_abs_err": max(r["max_abs_err"] for r in shapes),
        "check": "ok",
        "timed_as": "bf16, B=64: 3x(4,200) + 2x(145,4) + 2x(4,145), "
                    "the 7 launches of one embed_images batch, L2 flushed",
        "ms": path_sum("ms"),
        "plain_ms": path_sum("plain_ms"),
        "bound_ms": path_sum("bound_ms"),
        "bound_by": ("bytes" if all(r["bound_by"] == "bytes" for r in bf16)
                     else "operations"),
        "library_ms": path_sum("library_ms"),
        "shapes": shapes,
    }, flash_entry("flash_tower_attention_fwd", 84, "fwd", train_launches[0],
                   slice_launches[0], hires_launches[0], large_launches[0],
                   fit_launches[0], ("out", "lse")),
        flash_entry("flash_tower_attention_bwd", 110, "bwd",
                    train_launches[1], slice_launches[1], hires_launches[1],
                    large_launches[1], fit_launches[1], ("dq", "dk", "dv")),
        chunk_entry("flash_chunked_attention_fwd", 429, "fwd",
                    slice_launches[2], SLICE_STEP_LAUNCHES[True][2],
                    ("out", "lse")),
        chunk_entry("flash_chunked_attention_bwd", 478, "bwd",
                    slice_launches[3], SLICE_STEP_LAUNCHES[True][3],
                    ("dq", "dk", "dv")),
        tiled_entry("flash_tiled_attention_fwd", 267, "fwd",
                    "tiled_fwd_launches"),
        tiled_entry("flash_tiled_attention_dq", 318, "dq",
                    "tiled_dq_launches"),
        tiled_entry("flash_tiled_attention_dkv", 349, "dkv",
                    "tiled_dkv_launches"),
        infonce_entry("infonce_stats", 86, "stats",
                      large_launches[STEP_COUNTERS.index("stats_launches")],
                      ("lse", "pos_sum", "pos_cnt")),
        infonce_entry("infonce_bwd_dq", 202, "dq",
                      large_launches[STEP_COUNTERS.index("dq_launches")],
                      ("dq",)),
        infonce_entry("infonce_bwd_dk", 229, "dk",
                      large_launches[STEP_COUNTERS.index("dk_launches")],
                      ("dk",)),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
