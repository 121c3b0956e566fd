#!/usr/bin/env python3
"""Drive the PyTorch port (`leccr_torch`) on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, each printing one JSON line (any failure raises: exit code 1):

1. device + build: the card's name and power limit (nvidia-smi), then the
   CUDA kernels built from `leccr_torch/csrc/` with nvcc, one process per
   source, side by side (seconds, ptxas report; the wgmma kernels of 4-8,
   both files' wrappers, every instantiation of kernels 2/3's Hopper
   kernels, and the InfoNCE kernels 9-11 with their merge passes must show
   0 spill bytes).
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
   bf16 path shape must take the Hopper variant (wgmma and TMA; the
   backward one launch), f32 and the unaligned shape the scalar one
   (`single_block_variant`, and the wgmma launch counters `tc_*`), and
   two calls must give the same bits.  Tolerance: f32
   out and lse atol 1e-5, grads 1e-4; bf16 lse 1e-5 and every other
   element within 1e-5 + BF16_K bf16 ulps of the sum of the absolute
   values of its terms (see flash_term_scales).  Timed like phase 2, with
   SDPA at rate 0 (forward, and the backward alone of a saved forward) as
   the yardstick.  Then, untimed, the ragged lengths FLASH_RAGGED at 12
   heads (1-192 keys, the vision length 145 among them) with key padding,
   a fully padded row and dropout 0.1, the vision shape with a fully
   padded row at rate 0, and cross shapes with 700 and 800 queries
   (`single_ragged_checks`), each on the Hopper variant, with the same
   tolerance and twice bit for bit.  Then the dropout masks that the
   forward and the backward apply (read back through its dq and its dv),
   read back bit for bit at the text shape (`single_masks`), must equal
   keep_mask.
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
   kernels 2/3 on the wgmma variant and every launch of kernels 4-8
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
   the wgmma variant, kernel 1 7 launches an embed_images batch on
   its small bodies; finite losses every step and finite sumR; log.txt
   and best.json; the last checkpoint restored into a second
   Trainer(resume) bit for bit.  Host-fed ms/step, the loader's wait,
   eval s per split (uncached, cached), checkpoint s and bytes.
12. checkpoint: weights in and out at full width (`checkpoint_phase`):
   configs/multi30k_en_xlmr.yaml's model uncut (ViT-B/32 @384 +
   XLM-R-base) from synthetic files; a reference-format .pth exported from
   a seeded model (plus dead X-VLM keys) imported by `python -m
   leccr_torch.run --checkpoint` bit for bit, 2 epochs trained with the
   Unigram tokenizer (kernels 2/3 36 / 24 a step, kernel 1 7 an eval
   batch), `--task export` re-imported bit for bit, an Embedder serving
   the export (ranks equal a dense count); an OpenAI-CLIP-layout ViT-B/32
   at its 7 x 7 grid into the flagship with the CLIP caption encoder
   (position table = interpolate_pos_embed of the file's, 2 steps, the
   tower unmoved, kernels 2/3 24 / 24 a step); native tokenizers equal
   the Python ones (texts/s).
13. video (`video_phase`): configs/msrvtt.yaml's model uncut (temporal
   tower over 4096-d frames, mBERT-base, caption interaction 3/2/2 at
   width 4096, so Dh = 512; bf16 on f32 masters).  Kernel 1's wide-head
   bodies against their plain version at the video shapes (VIDEO_SHAPES
   timed beside the bound and SDPA, two calls bit for bit,
   VIDEO_EDGE_SHAPES checked, and a row whose first key split or first
   warp's key range is all padded, `wide_padded_range_checks`; phase 2's
   tolerances), then `python -m leccr_torch.run --task vtr_caption` on a
   synthetic MSR-VTT-layout set (512 clips, 4 steps at bs128; val and
   test of 1000 videos x 5 captions): kernels 2/3 VIDEO_STEP_LAUNCHES a
   step, all on the wgmma variant, kernel 1 7 launches an eval batch on the
   wide-head bodies only (5 key ranges, 2 query rows a batch); the test
   split's double-sim ranks equal a dense count; ms/step, peak memory,
   embed_texts / embed_images / ranking s;
   then build_video_index of 256 videos and search_texts(minmax); then
   `--task build_index` of the test split from the run's checkpoint
   (kernel 1 7 a batch of 64, wide bodies only) and search_texts(minmax)
   on the loaded save.  Then configs/vatex.yaml's model uncut (1024-d
   frames, so Dh = 128: kernel 1's small bodies), bf16: one embed_images
   batch of 64 videos (32 frames, some padded; 200-token captions), each
   of its 7 kernel 1 calls held to the plain version on the same inputs
   with phase 2's bf16 tolerance (`vatex_check`; few-queries and few-keys
   bodies only).
14. serving tasks (`serve_tasks_phase`): configs/multi30k_all.yaml's
   model from fit's last checkpoint over a synthetic Multi30K test split
   of 1000 images, through `leccr_torch.run.main`: `--task build_index`
   f32, `--int8` and `--ivf --ivf_recall 0.95` (kernel 1 7 a batch of 64,
   small bodies only); `--task update_index` removing 50 items and adding
   them back (7 launches; re-added rows within 1e-2 of the originals,
   int8 rows untouched bit for bit); `--task serve --port 0` of each save
   in child processes, 32 concurrent clients whose answers equal an
   in-process search (scores within 1e-3), coalesced dispatches, then 32
   clients sending fresh requests back to back for SERVE_WINDOW_S s a
   save, SIGINT exits 0.  Build, embed, save and load s, bytes on disk,
   and over each window requests/s and client p50 / p95.
15. the index at scale (`index_scale_phase`, no model): 1M unit rows at E
   = 256 with 4 slots around 1000 concepts, IVF of C = 4000 clusters:
   the full probe equals the exact search (1e-5), the calibrated nprobe
   reaches recall@10 0.95, int8 within 0.03 (exact) and 5e-3 (IVF) of
   f32, two builds from one seed bit for bit, equal rows tie bit for
   bit; quantize, k-means, pack, calibrate and each search timed, exact
   f32 (`pairwise_scores`) beside `torch.matmul` of the same product.
16. RandAugment (`randaugment_phase`, after the flagship step): a bs128 x
   384² batch (uint8 / 255 once, on the host) through the live policy (n
   = 2, m = 7) on the card and on the CPU from one generator state: each
   image within 1e-5 of the
   CPU's (1/255 where an affine op fired); ms per batch and each of the 16
   ops' ms on the whole batch; then the flagship train step with
   `data.randaugment: true` (2 warm-up, 3 timed, a profiled step): kernels
   2/3 FLAGSHIP_STEP_LAUNCHES a step, ms/step and device ms beside phase
   8's step without it.
17. the ring (`ring_phase`, after phase 5): `parallel.ring.ring_infonce`
   (impl "fused": kernels 9-11, the one-process replay of the ranks'
   schedules) at W = 8 x b_local = 4096, E = 256 (configs/
   scale_vitl_32k.yaml's 32 768 global negatives), forward and backward:
   exactly 128 launches of each of kernels 9, 10 and 11 (8 ranks x 8
   blocks x 2 directions); the loss within 1e-5 of max(1, |x|), the
   feature gradients within 1e-4 of their largest element and d temp
   within 1e-4 of max(1, |x|) of `ops.infonce.infonce_loss` on the same
   32 768 rows; ms of both.
18. data-parallel (`distributed_phase`, after phase 14): `python -m
   leccr_torch.run --task itr_caption --multihost` in this process under
   torchrun's environment for a world of one (NCCL, rank 0) at the
   flagship's width (configs/multi30k_all.yaml from synthetic files, 2
   steps at bs128, negatives ring_fused, eval, a checkpoint after each
   step) beside the same run without --multihost: kernels 2/3
   FLAGSHIP_STEP_LAUNCHES a step in both, kernels 9-11 6 a step through
   the W = 1 ring (0 without the group: one block's ring_fused is the
   dense loss), kernel 1 7 an eval batch; the Adam first moments (the
   clipped gradient) of the step-1 checkpoint within DIST_MOMENT_BOUND
   (relative, per parameter that carries signal) of the run without the
   group; rank 0's checkpoint; `--devices 2` raises on
   this one-GPU host.  W > 1 is checked only in the CPU tests (gloo).
19. the sharded index (`sharded_serve_phase`, inside phase 15): phase
   15's 1M rows row-sharded 4 ways on cuda:0 (`serve.shard_index`): the
   top-10 of 64 queries equal the unsharded search's bit for bit, f32 and
   int8, fusion none and minmax; ms per batch.
20. tensor parallelism (`tensor_parallel_phase`, last): the model ranks
   of one data rank replayed in one process (`parallel.tensor.
   replay_model_ranks`) at full width in bf16 (TP_CASES): the flagship's
   ViT-B/32 @384 (bs128 x 145) and mBERT-base (bs128 x 128, key padding)
   at M = 2 and 4 (kernels 2/3), ViT-L/14 @336 (bs32 x 577, kernels 4/5)
   and @728 (bs8 x 2705, kernels 6-8, head_group(16) = 8 across two
   ranks) at M = 4.  Each rank's heads through the kernels at its offset
   and the layer's H, forward and backward at dropout 0.1, against the
   dense call's heads (bit for bit expected; held to 1e-5 + BF16_K ulps);
   the masks the kernels apply on rank 1's heads, read back, equal to
   `keep_mask` / `tile_keep_mask` at the offset and the layer's head
   group; the ranks' block (mBERT layer at dropout 0.1, CLIP blocks at
   their rate 0) against the dense block, both bf16, with the f32 dense
   block as reference: per tensor (output, dx, each parameter's gradient)
   max |ranks - dense| <= 2 max |dense - f32| + M bf16 ulps of max |f32|;
   exactly M launches of each of the regime's kernels a replay; rank 0's
   block alone (collectives as local stand-ins) beside the dense block:
   device ms (profiler) and event ms.
21. FSDP (`fsdp_phase`, last): `parallel.fsdp` on one card through
   `parallel.fsdp.LocalDataGroup` (D = FSDP_BLOCKS data ranks' shards
   stacked on the device, gathered at use, gradients sliced).  (a)
   configs/multi30k_all.yaml uncut (ViT-B/32 @384 + mBERT-base, bf16 on
   f32 masters, bs128, kernels 2/3): 2 steps of `TrainStep(num_blocks=4)`
   at the default floor beside the same steps without FSDP: losses,
   parameters and Adam moments bit for bit; kernels 2/3
   FLAGSHIP_STEP_LAUNCHES a step; a rank's bytes of parameters plus
   moments against the dense state's, the sharded and replicated
   parameter counts, and the step's device ms (profiler) beside the step
   without FSDP.  (b) configs/scale_vitl_32k.yaml's model at full width
   (ViT-L/14 @336 + XLM-R-large, remat, ring_fused, GradCache 2, FSDP)
   at num_blocks 4 without the model axis, cut to bs32 (the config's
   32 768 rows need 8+ cards) and to 8-row loss blocks (its 256 would
   leave a 32-row batch unstreamed): 2 steps beside the steps without
   FSDP (at the first, the first caption cross-attention's key bias has
   an exactly zero gradient: the query slots start at zero), losses,
   parameters and moments bit for bit, finite losses, every parameter
   moved;
   kernels 9-11 launched, as many times as without FSDP; device ms and
   peak memory.  Both parts run under torch's deterministic algorithms
   (the CUDA embedding backward's sum over a repeated index varies run to
   run otherwise: the token-type table's, 1 index x 16 384 rows).

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
import signal
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
# the video model's (configs/msrvtt.yaml: 4096-d frames at 8 heads, Dh =
# 512) embed_images calls, on the two wide-head bodies: (slots, caption
# tokens at max_tokens) and (slots, frames) on wide key ranges, (frames,
# slots) on wide query rows; checked only: the 64- and 128-token buckets
# (past the general body's 52 keys at Dh = 512), one key, the bodies'
# edges (2 and 3 keys, 4-row groups, 32-row blocks), key counts that no
# split or warp range divides, and 3-16 keys over 3 to 145 rows (a warp's
# own rows)
VIDEO_DH = 512
VIDEO_SHAPES = [(2, 200), (32, 2), (2, 32)]
VIDEO_PATH_LAUNCHES = {(2, 200): 3, (32, 2): 2, (2, 32): 2}
VIDEO_BODIES = {(2, 200): "wide_key_ranges", (32, 2): "wide_query_rows",
                (2, 32): "wide_key_ranges"}
VIDEO_EDGE_SHAPES = [(2, 64), (2, 128), (1, 1), (17, 33), (32, 16),
                     (2, 33), (2, 199), (2, 1), (33, 17), (32, 3), (145, 4),
                     (3, 16)]
# (B, Lq, Lk) of `wide_padded_range_checks`: the path's batch (one split:
# the first warp's range padded) and 2 videos (16 heads: the keys split
# over blocks, the first split padded)
WIDE_PADDED_CASES = [(64, 2, 200), (2, 2, 200), (2, 2, 33), (2, 5, 199)]
# the video phase's cuts of configs/msrvtt.yaml (widths uncut): synthetic
# frame features, 512 training clips with one caption each (4 steps at
# bs128, one epoch), 1000 videos x 5 captions a split (msrvtt10ktest has
# 2990 x 20), 256 videos indexed for serving
VIDEO_TRAIN_CLIPS = 512
VIDEO_EVAL_VIDEOS = 1000
VIDEO_EVAL_CAPTIONS = 5
VIDEO_SERVE_VIDEOS = 256
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
# views take, checked and timed beside the Hopper (wgmma) one
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
# kernels 2/3's ragged key counts on the Hopper variant (single_ragged_checks):
# around the 16-key steps and 64-key boxes, the vision length 145 and the
# 192-key limit (TC_MAX_KEYS)
FLASH_RAGGED = (1, 17, 63, 64, 65, 128, 145, 168, 192)
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
TC_COUNTERS = ("tc_fwd_launches", "tc_bwd_launches")  # kernels 2/3 on the
# Hopper (wgmma) variant: a subset of fwd_launches / bwd_launches
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
# a video step: kernel 2 on the text tower (12 layers, source + target in
# one call) and on the caption pass (12, forward only), kernel 3 on the
# text tower's backward; the temporal tower's attention is plain
VIDEO_STEP_LAUNCHES = (24, 12, 0, 0, 0, 0, 0, 0, 0, 0)
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


def kernel1_within(diff, want):
    """(ok, tolerance) of kernel 1's |got - want| against its plain
    version's `want`: f32 max abs err <= 1e-5, bf16 every element within
    1e-5 + 1 bf16 ulp of `want`."""
    import torch

    if want.dtype == torch.float32:
        return diff.max().item() <= 1e-5, "max abs err <= 1e-5"
    return (bool((diff <= 1e-5 + bf16_ulp(want)).all()),
            "every element within 1e-5 + 1 bf16 ulp")


def wide_padded_range_checks(heads: int = 8, dh: int = VIDEO_DH):
    """Kernel 1's wide key-ranges body at WIDE_PADDED_CASES (B, Lq, Lk), in
    the path's layout, bf16 and f32: batch row 0 has the keys of its first
    split padded (of the first warp's range where the call runs one split)
    and no other key, row 1 every key, the others none.  Out within
    `kernel1_within` of the plain version, row 1 the mean of v, two calls
    bit for bit; each row with the call's splits (`wide_splits`)."""
    import torch

    from leccr_torch.ops.fused_cross_attention import (
        WIDE_WARPS,
        fused_body,
        fused_cross_attention,
        fused_cross_attention_reference,
        wide_splits,
    )

    results = []
    for batch, lq, lk in WIDE_PADDED_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            g = torch.Generator(device="cuda").manual_seed(batch * lk + lq)
            q, k, v = (torch.randn(batch, n, heads, dh, device="cuda",
                                   generator=g).to(dtype).transpose(1, 2)
                       for n in (lq, lk, lk))
            if fused_body(lq, lk, dh, q.element_size(),
                          True) != "wide_key_ranges":
                raise AssertionError(f"{lq}x{lk} is not a key-ranges shape")
            splits, split_keys = wide_splits(batch * heads, lq, lk, dh,
                                             dtype, q.device)
            span = split_keys if splits > 1 else -(-lk // WIDE_WARPS)
            if span >= lk:
                raise AssertionError(f"{batch}x{lq}x{lk}: one range holds "
                                     f"every key ({splits} splits)")
            pad = torch.zeros(batch, lk, dtype=torch.bool, device="cuda")
            pad[0, :span] = True
            pad[1] = True
            got = fused_cross_attention(q, k, v, pad)
            want = fused_cross_attention_reference(q, k, v, pad)
            diff = (got.float() - want.float()).abs()
            ok, tol = kernel1_within(diff, want)
            mean_v = v[1].float().mean(dim=1, keepdim=True).expand(-1, lq, -1)
            mean_err = (got[1].float() - mean_v).abs().max().item()
            if (not ok or mean_err > 1e-2 or not torch.isfinite(got).all()
                    or not torch.equal(fused_cross_attention(q, k, v, pad),
                                       got)):
                raise AssertionError(
                    f"kernel 1 with a padded key range at {batch}x{lq}x{lk} "
                    f"{dtype}: err {diff.max().item()}, mean of v off by "
                    f"{mean_err}, {splits} splits of {split_keys} keys")
            results.append({"batch": batch, "lq": lq, "lk": lk,
                            "dtype": str(dtype).split(".")[-1],
                            "padded_keys": span, "splits": splits,
                            "split_keys": split_keys,
                            "max_abs_err": diff.max().item(),
                            "padded_row_vs_mean_v": mean_err,
                            "tolerance": tol, "two_calls": "bit for bit"})
            emit("video_kernel_padded_range", dh=dh, **results[-1])
    return results


def kernel_phase(batch: int = 64, heads: int = 8, dh: int = 64,
                 shapes=tuple(SHAPES), edges=tuple(EDGE_SHAPES),
                 phase: str = "kernel"):
    """Kernel 1 against its plain version at `shapes` (timed, beside its
    bound, the plain version and SDPA) and `edges` (checked only), in bf16
    (the path's dtype) and f32, each launch on the body `fused_body` picks
    (read from the per-body counters): the image model's SHAPES and
    EDGE_SHAPES at Dh = 64 by default, the video model's at Dh = 512 with
    phase="video_kernel"."""
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
    for lq, lk in list(shapes) + list(edges):
        timed = (lq, lk) in shapes
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
            ok, tol = kernel1_within(diff, want)
            if not ok:
                raise AssertionError(f"kernel disagrees with its plain "
                                     f"version at {lq}x{lk} {dtype}: {err}")
            if not torch.equal(fused_cross_attention(q, k, v, pad), got):
                raise AssertionError(f"kernel 1 at {lq}x{lk} {dtype}: two "
                                     f"calls differ")
            name = str(dtype).split(".")[-1]
            row = {"lq": lq, "lk": lk, "dtype": name, "body": body,
                   "max_abs_err": err, "padded_row_vs_mean_v": mean_err,
                   "tolerance": tol, "two_calls": "bit for bit"}
            if not timed:
                emit(f"{phase}_edge_vs_plain", dh=dh, **row)
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
                **row, "dh": dh, "ms": ms, "plain_ms": plain_ms,
                "library_ms": library_ms, "bytes": n_bytes, "flops": flops,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations"})
            emit(f"{phase}_vs_plain", **results[-1])
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


def kernel1_counts(what: str, bodies=("few_queries", "few_keys")) -> dict:
    """Kernel 1's launches since reset_counts(), all and by body; `what`
    (a path) must have launched each of `bodies` and no other (the image
    model's embed_images shapes: the few-queries and few-keys bodies, never
    the general one; the video model's: the wide-head bodies, whose exact
    counts `video_kernel1_counts` checks)."""
    from leccr_torch.ops.fused_cross_attention import fused_cross_attention

    by_body = fused_cross_attention.launches_by_body
    counts = {"all": fused_cross_attention.launches, **by_body}
    if (any((by_body[b] > 0) != (b in bodies) for b in by_body)
            or counts["all"] != sum(by_body.values())):
        raise AssertionError(f"{what} launched kernel 1's bodies {counts}")
    return counts


def video_kernel1_counts(what: str, cfg, batches: int) -> dict:
    """`kernel1_counts` of `what`, `batches` embed_images batches of the
    video model: per batch its caption_ca_layer calls (slots, caption
    tokens) and caption_interaction_layer (slots, frames) calls on wide key
    ranges, caption_interaction_layer (frames, slots) calls on wide query
    rows, exactly."""
    counts = kernel1_counts(what, tuple(sorted(set(VIDEO_BODIES.values()))))
    inter = cfg.model.caption_interaction_layer
    want = {"wide_key_ranges": (cfg.model.caption_ca_layer + inter) * batches,
            "wide_query_rows": inter * batches}
    if any(counts[b] != n for b, n in want.items()):
        raise AssertionError(f"{what} launched kernel 1's bodies {counts}, "
                             f"want {want}")
    return counts


def tc_counts():
    """Launches of kernels 2/3 on the Hopper (wgmma) variant so far."""
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
        if variant != ("wgmma" if dtype == torch.bfloat16 and aligned
                       else "scalar"):
            raise AssertionError(f"{name} {dtype} takes the {variant} "
                                 f"variant")
        before = tc_counts()
        out, lse = flash_tower_attention_fwd(q, k, v, pad, seed, rate)
        grads = flash_tower_attention_bwd(q, k, v, pad, lse, grad, seed,
                                          rate)
        tc_launched = tuple(a - b for a, b in zip(tc_counts(), before))
        if tc_launched != ((1, 1) if variant == "wgmma" else (0, 0)):
            raise AssertionError(f"{name} {dtype}: wgmma launches "
                                 f"{tc_launched} on the {variant} variant")
        again = (flash_tower_attention_fwd(q, k, v, pad, seed, rate),
                 flash_tower_attention_bwd(q, k, v, pad, lse, grad, seed,
                                           rate))
        if not (torch.equal(again[0][0], out) and torch.equal(again[0][1], lse)
                and all(torch.equal(a, b) for a, b in zip(again[1], grads))):
            raise AssertionError(f"{name} {dtype}: two calls differ")
        del again
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
    ragged = single_ragged_checks(dh, seed)
    # the masks each kernel applies, bit for bit, at the text shape
    _, batch, heads, length, rate, _, _ = FLASH_SHAPES[1]
    want = keep_mask(seed, batch, heads, length, length, rate,
                     device="cuda") != 0
    before = tc_counts()
    masks = single_masks(batch, heads, length, torch.bfloat16, rate, seed)
    equal = [bool(torch.equal(m, want)) for m in masks]
    tc_launched = tuple(a - b for a, b in zip(tc_counts(), before))
    emit("flash_masks", shape=[batch, heads, length, length], rate=rate,
         kernels=["forward (out)", "backward (dq)", "backward (dv)"],
         equal=equal, kept_share=want.float().mean().item(),
         tc_launches=tc_launched)
    if not all(equal) or 0 in tc_launched:
        raise AssertionError(f"kernels 2/3's masks differ from keep_mask: "
                             f"{equal}, wgmma launches {tc_launched}")
    results.extend(ragged)
    return results


def single_ragged_checks(dh: int = 64, seed: int = 1234):
    """Kernels 2/3 on the Hopper variant against their plain versions,
    untimed, at the lengths FLASH_RAGGED (12 heads, batch 4, key padding
    with a fully padded row, dropout 0.1; 192 keys, past fits_vmem at 12
    heads, through the runners that `flash_tower_attention_fwd/_bwd` call
    after their checks), at the vision shape [128,12,145,64] with key
    padding and a fully padded row at rate 0, and at 700 and 800 queries
    against 64 keys (queries stream, so their count is free).  Each must
    take the wgmma variant (one launch each way), agree within phase 3's
    bf16 tolerance, and give the same bits twice.  Returns one row each
    (emitted as "flash_ragged")."""
    import torch

    from leccr_torch.ops import flash_attention as fa

    cases = [(4, 12, n, n, 0.1) for n in FLASH_RAGGED]
    cases += [(128, 12, 145, 145, 0.0), (2, 1, 800, 64, 0.1),
              (2, 2, 700, 64, 0.1)]
    rows = []
    for batch, heads, lq, lk, rate in cases:
        g = torch.Generator(device="cuda").manual_seed(lq * 1000 + lk)
        q, k, v, grad = (path_layout(torch.randn(
            batch, n, heads, dh, device="cuda", generator=g).to(
                torch.bfloat16)) for n in (lq, lk, lk, lq))
        pad = torch.rand(batch, lk, device="cuda", generator=g) < 0.3
        pad[0] = True  # a fully padded row: the mean of v over the Lk keys
        pad[1] = False
        variant = fa.single_block_variant(q, k, v, grad)
        mask = fa._mask_bytes(pad)
        before = tc_counts()
        out, lse = fa._single_fwd(q, k, v, mask, seed, rate)
        grads = fa._single_bwd(q, k, v, mask, lse, grad, seed, rate)
        launched = tuple(a - b for a, b in zip(tc_counts(), before))
        out2, lse2 = fa._single_fwd(q, k, v, mask, seed, rate)
        grads2 = fa._single_bwd(q, k, v, mask, lse, grad, seed, rate)
        same = (torch.equal(out, out2) and torch.equal(lse, lse2)
                and all(torch.equal(a, b) for a, b in zip(grads, grads2)))
        want_out, want_lse = fa.flash_tower_attention_fwd_reference(
            q, k, v, pad, seed, rate)
        want_grads = fa.flash_tower_attention_bwd_reference(
            q, k, v, pad, want_lse, grad, seed, rate)
        torch.cuda.synchronize()
        pairs = {"out": (out, want_out),
                 **dict(zip(("dq", "dk", "dv"), zip(grads, want_grads)))}
        scales = flash_term_scales(q, k, v, pad, want_lse, grad, seed, rate)
        k_needed = {n: bf16_k_needed(a, w, scales[n])
                    for n, (a, w) in pairs.items()}
        lse_err = (lse - want_lse).abs().max().item()
        finite = all(bool(torch.isfinite(a).all()) for a, _ in pairs.values())
        rows.append({
            "shape": f"ragged-{lq}x{lk}", "direction": "fwd+bwd",
            "dtype": "bfloat16", "variant": variant, "b": batch, "h": heads,
            "lq": lq, "lk": lk, "dh": dh, "rate": rate, "masked": True,
            "max_abs_err": {"lse": lse_err, **{
                n: (a.float() - w.float()).abs().max().item()
                for n, (a, w) in pairs.items()}},
            "bf16_ulps": k_needed, "launched": launched,
            "bit_identical": same})
        emit("flash_ragged", **rows[-1])
        if not (variant == "wgmma" and launched == (1, 1) and same and finite
                and lse_err <= 1e-5 and max(k_needed.values()) <= BF16_K):
            raise AssertionError(f"kernels 2/3 at {rows[-1]}")
        del q, k, v, grad, out, grads, out2, grads2, want_out, want_grads
    return rows


def single_masks(batch, heads, length, dtype, rate, seed, dh=64,
                 span=(0, None)):
    """The dropout masks that kernel 2 and kernel 3 apply, read back bit
    for bit through the forward's out and the backward's dq and dv ([B, H,
    L, L] bool, True = kept), one block of dh keys (or queries) at a
    time.  With q = k = 0 every score is 0 and the
    forward's p is 1/L, so with v the identity on keys [c, c + dh) its
    out[i, d] = round(keep_ij / L) for j = c + d is nonzero exactly where
    (i, j) is kept.  The backward is given lse = log(2L), so p = 1/(2L) and
    sum_j p = 1/2: with k = v = that identity and g = 1 the backward has
    dp_ij = keep_ij on the block, delta_i = sum_j keep_ij / (2L) <= keep/2
    and ds_ij = p (dp_ij - delta_i) scale, positive exactly where kept, so
    dq[i, d] = round(ds_ij) > 0 there; with g the identity on queries
    [c, c + dh) and q = k = v = 0 the backward gives dv[j, d] =
    round(pd_ij) for i = c + d, nonzero exactly where kept.  span: (h0,
    H), the heads' offset and the layer's head count (tensor
    parallelism)."""
    import functools

    import torch

    from leccr_torch.ops import flash_attention as fa

    at = dict(head_offset=span[0], num_heads=span[1])
    flash_tower_attention_fwd = functools.partial(
        fa.flash_tower_attention_fwd, **at)
    flash_tower_attention_bwd = functools.partial(
        fa.flash_tower_attention_bwd, **at)

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


def chunk_bwd_masks(batch, heads, length, dtype, rate, seed, dh=64,
                    span=(0, None)):
    """The dropout masks that kernel 5's dq and dk/dv passes apply, read back
    bit for bit ([B, H, Lq, Lk] bool, True = kept), two launch pairs per
    64-row block: with q = 0, k = v = the identity on key block [c, c + 64),
    g = 1 and out = 0 (delta 0), dq[i, d] = ds[i, c + d]; with q = k = v = 0
    and g the identity on query block c, dv[j, d] = pd[c + d, j].  span:
    as `single_masks`'."""
    import functools

    import torch

    from leccr_torch.ops import flash_attention as fa

    at = dict(head_offset=span[0], num_heads=span[1])
    flash_chunked_attention_bwd = functools.partial(
        fa.flash_chunked_attention_bwd, **at)
    flash_chunked_attention_fwd = functools.partial(
        fa.flash_chunked_attention_fwd, **at)

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


def fwd_masks(fwd, batch, heads, length, dtype, rate, seed, dh=64,
              span=(0, None)):
    """The dropout mask that a streamed forward (`fwd`: kernel 4's or 6's
    wrapper) applies, read back bit for bit ([B, H, Lq, Lk] bool, True =
    kept), one 64-key block per launch.  With q = k = 0 every score is 0
    and p = 1/L, so with v the identity on block [c, c + 64) out[i, d] is
    nonzero exactly where (i, c + d) is kept.  span: as `single_masks`'."""
    import torch

    zeros = path_layout(torch.zeros((batch, length, heads, dh), dtype=dtype,
                                    device="cuda"))
    mask = torch.empty((batch, heads, length, length), dtype=torch.bool,
                       device="cuda")
    for c, n, block in identity_blocks(batch, heads, length, dtype, dh):
        out, _ = fwd(zeros, zeros, block, None, seed, rate,
                     head_offset=span[0], num_heads=span[1])
        mask[..., c:c + n] = out[..., :n] != 0
    return mask


def tiled_masks(batch, heads, length, dtype, rate, seed, dh=64,
                span=(0, None)):
    """The dropout masks that kernels 6, 7 and 8 apply, read back bit for
    bit ([B, H, Lq, Lk] bool, True = kept), one 64-key (or 64-query) block
    per launch: kernel 6's by `fwd_masks`; kernel 7 with q = 0, k = v =
    the identity on block [c, c + 64), g = 1 and out = 0 (delta 0) gives
    dq[i, d] = ds[i, c + d], and kernel 8 with g the identity on query
    block c gives dv[j, d] = pd[c + d, j].  span: as `single_masks`'."""
    import functools

    import torch

    from leccr_torch.ops import flash_attention as fa

    at = dict(head_offset=span[0], num_heads=span[1])
    flash_tiled_attention_dkv = functools.partial(
        fa.flash_tiled_attention_dkv, **at)
    flash_tiled_attention_dq = functools.partial(
        fa.flash_tiled_attention_dq, **at)
    flash_tiled_attention_fwd = functools.partial(
        fa.flash_tiled_attention_fwd, **at)

    shape = (batch, length, heads, dh)
    zeros = path_layout(torch.zeros(shape, dtype=dtype, device="cuda"))
    ones = path_layout(torch.ones(shape, dtype=dtype, device="cuda"))
    _, lse = flash_tiled_attention_fwd(zeros, zeros, zeros, None, seed, rate)
    delta = torch.zeros_like(lse)
    masks = [fwd_masks(fa.flash_tiled_attention_fwd, batch, heads, length,
                       dtype, rate, seed, dh, span)]
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
    tc = tc_counts()  # bf16 at Dh = 64: kernels 2/3 on the wgmma variant
    if cfg.model.dtype == "bfloat16" and tc != launches[:2]:
        raise AssertionError(f"kernels 2/3 launched {launches[:2]}, of them "
                             f"{tc} on the wgmma variant")
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


# the __global__ functions of kernels 2/3, scalar and Hopper variants
SINGLE_WGMMA_KERNELS = ("single_fwd_wgmma_kernel", "single_bwd_wgmma_kernel")
SINGLE_BLOCK_KERNELS = {"fwd_kernel": "single_fwd",
                        "single_fwd_wgmma_kernel": "single_fwd",
                        "bwd_dq_kernel": "single_bwd",
                        "bwd_dkv_kernel": "single_bwd",
                        "single_bwd_wgmma_kernel": "single_bwd"}
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
_PTXAS_STACK = re.compile(r"(\d+) bytes stack frame")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")


def ptxas_functions(log: str) -> dict:
    """Registers and spill bytes that ptxas -v reports in `log`, by mangled
    function name: {name: {"registers": n, "spill_stores": bytes,
    "spill_loads": bytes}}."""
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
    return found


def ptxas_report(log: str, names) -> dict:
    """`ptxas_functions` of each kernel of `names` (found by its name inside
    the mangled one), None for a kernel the log does not show."""
    found = ptxas_functions(log)
    return {name: next((v for k, v in found.items() if name in k), None)
            for name in names}


_MANGLED_INT_ARGS = re.compile(r"ILi(\d+)E")
# kernel 1's wide-head kernels, and the instantiations the build must show:
# key ranges by (dtype, rows a warp), the split merge and query rows by
# dtype
FCA_WIDE_KERNELS = ("fca_wide_key_ranges_kernel", "fca_wide_merge_kernel",
                    "fca_wide_query_rows_kernel")
FCA_WIDE_INSTANCES = 8
_MANGLED_DTYPE = {"I13__nv_bfloat16": "bf16", "If": "f32"}


def fca_wide_instances(log: str) -> dict:
    """`ptxas_functions` of every compiled instantiation of
    FCA_WIDE_KERNELS and its "stack_frame" bytes, keyed
    "name<dtype[,rows]>" from the mangled name."""
    stacks, current = {}, None
    for line in log.splitlines():
        match, stack = _PTXAS_FN.search(line), _PTXAS_STACK.search(line)
        if match:
            current = match.group(1)
        elif current is not None and stack:
            stacks[current] = int(stack.group(1))
    found = {}
    for mangled, report in ptxas_functions(log).items():
        for name in FCA_WIDE_KERNELS:
            if name not in mangled:
                continue
            args = mangled[mangled.index(name) + len(name):]
            dtype = next(d for p, d in _MANGLED_DTYPE.items()
                         if args.startswith(p))
            rows = re.match(r"I(?:13__nv_bfloat16|f)Li(\d+)E", args)
            found[f"{name}<{dtype}{',' + rows.group(1) if rows else ''}>"] = {
                **report, "stack_frame": stacks.get(mangled)}
    return found


def ptxas_instances(log: str, names) -> dict:
    """`ptxas_functions` of every compiled instantiation of the templates
    `names`, keyed "name<N>" (their one int argument, from the mangled
    name)."""
    found = {}
    for mangled, report in ptxas_functions(log).items():
        for name in names:
            if name in mangled:
                args = _MANGLED_INT_ARGS.search(mangled[mangled.index(name):])
                found[f"{name}<{args.group(1) if args else ''}>"] = report
    return found


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
    namespace)::single_fwd_wgmma_kernel<10>(...)"), from its
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
    want_i2t, want_t2i = dense_ranks(img, txt, txt2img, img2txt)
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


def fit_phase(card_line: str, out: Path, seed: int = 0):
    """`Trainer(cfg).fit()` on the card: configs/multi30k_all.yaml at full
    width with FIT_OPTIONS, from files on disk (the synthetic set written
    in `out`).  Kernels 2/3 must launch
    FLAGSHIP_STEP_LAUNCHES a step (all on the wgmma variant) and
    kernel 1 launches_per_batch() an embed_images batch (its small bodies
    only), counted over every step and eval batch of the run; every step's
    losses finite, sumr finite, log.txt's records, best.json, and the last
    checkpoint restored into a second Trainer(resume) bit for bit (model,
    optimizer, step).  Prints host-fed ms/step (the median of the steps
    after each epoch's first, each ending in the loss read-back) and
    pairs/s, the loader's wait per step, eval s per split (epoch 0
    uncached, epoch 1 from the device cache), checkpoint save s and
    bytes, peak memory.  The run writes into `out`, which the caller
    removes.  Returns (kernel 2/3 launches, kernel 1 counts, the last
    checkpoint's path)."""
    import copy
    import statistics

    import torch

    from leccr_torch.config import load_config
    from leccr_torch.ops.fused_cross_attention import fused_cross_attention
    from leccr_torch.train.trainer import Trainer

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
                             f"them {tc} on the wgmma variant")
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
    return launches, by_body, str(files[0])


CHECKPOINT_OPTIONS = {**FIT_OPTIONS, "train.checkpoint_every_steps": 0}
# parameters of the reference's checkpoints that no LECCR module reads
DEAD_KEYS = {"itm_head.weight": (2, 768), "itm_head.bias": (2,),
             "clip_encoder.logit_scale": ()}
CLIP_MERGES = ["#version: 0.2", "t h", "th e</w>", "a</w>", "m a", "ma n</w>",
               "r e", "re d</w>", "d o", "do g", "dog s</w>", "b i", "bi k",
               "bik e</w>", "r i", "ri d", "rid e", "ride s</w>"]
NATIVE_TEXTS = 20000


def openai_clip_state_dict(variant, seed: int):
    """A seeded OpenAI-CLIP-layout state_dict at `variant`'s full widths
    and its native 224² grid (7 x 7 patches for ViT-B/32), vision and text,
    in fp16 as OpenAI ships it."""
    import torch

    g = torch.Generator().manual_seed(seed)
    w, tw, e = variant.vision_width, variant.text_width, variant.embed_dim
    grid = 224 // variant.patch_size

    def r(*shape, scale=0.02):
        return (scale * torch.randn(*shape, generator=g)).half()

    sd = {"visual.conv1.weight": r(w, 3, variant.patch_size,
                                   variant.patch_size),
          "visual.class_embedding": r(w),
          "visual.positional_embedding": r(grid * grid + 1, w),
          "visual.proj": r(w, e),
          "token_embedding.weight": r(variant.vocab_size, tw),
          "positional_embedding": r(variant.context_length, tw),
          "text_projection": r(tw, e), "logit_scale": torch.tensor(4.6052)}
    for prefix, width, layers in (("visual.transformer", w,
                                   variant.vision_layers),
                                  ("transformer", tw, variant.text_layers)):
        for i in range(layers):
            b = f"{prefix}.resblocks.{i}"
            sd[f"{b}.attn.in_proj_weight"] = r(3 * width, width)
            sd[f"{b}.attn.in_proj_bias"] = r(3 * width)
            for name, (o, k) in {"attn.out_proj": (width, width),
                                 "mlp.c_fc": (4 * width, width),
                                 "mlp.c_proj": (width, 4 * width)}.items():
                sd[f"{b}.{name}.weight"] = r(o, k)
                sd[f"{b}.{name}.bias"] = r(o)
            for ln in ("ln_1", "ln_2"):
                sd[f"{b}.{ln}.weight"] = 1 + r(width)
                sd[f"{b}.{ln}.bias"] = r(width)
    for ln, width in (("visual.ln_pre", w), ("visual.ln_post", w),
                      ("ln_final", tw)):
        sd[f"{ln}.weight"] = 1 + r(width)
        sd[f"{ln}.bias"] = r(width)
    return sd


def checkpoint_phase(card_line: str, seed: int = 1):
    """Weights in and out at full width, through the entry points.

    configs/multi30k_en_xlmr.yaml's model, uncut (ViT-B/32 @384 +
    XLM-R-base, 250 002 x 768, 12 layers; caption interaction 3/2/2; bf16
    on f32 masters), synthetic data as in fit_phase (CHECKPOINT_OPTIONS: 4
    steps, 2 epochs, no mid-epoch snapshot), a derived yaml in a temporary
    directory, removed after:
    1. a reference-format .pth exported from a model built from `seed`,
       plus DEAD_KEYS (bytes and write s);
    2. `python -m leccr_torch.run --task itr_caption --checkpoint` it:
       every parameter equals the seed model's bit for bit before the
       first step, the dead keys are reported unused and nothing else an
       issue; kernels 2/3 FLAGSHIP_STEP_LAUNCHES a step (all on the wgmma variant)
       and kernel 1 launches_per_batch() an eval batch; finite losses
       (import s, host-fed ms/step, the loader's tokenizer);
    3. `--task export` of the trained checkpoint, re-imported into a fresh
       model: every parameter equals the trained one's bit for bit;
    4. an Embedder with `checkpoint=` the export and the Unigram tokenizer
       indexes 256 images and answers 3 queries; its top-10 ranks equal a
       dense count of the same scores; kernel 1 7 launches a batch;
    5. an OpenAI-CLIP-layout file (ViT-B/32 at its native 7 x 7 grid,
       vision and text) into configs/multi30k_all.yaml's model with
       `caption_encoder_name: clip` and a synthetic merges file: the
       position table equals interpolate_pos_embed of the file's; 2 train
       steps with finite losses, kernels 2/3 24 / 24 a step (the causal
       CLIP tower runs none), the CLIP tower's parameters unchanged;
    6. native against Python tokenizers on NATIVE_TEXTS synthetic
       sentences: equal ids, texts/s of each, WordPiece and Unigram.
    Returns (kernel 2/3 launches of 2 and 5, kernel 1 launches of 2 and
    4)."""
    import shutil
    import statistics
    import tempfile

    import numpy as np
    import torch
    import yaml

    from leccr_torch import run
    from leccr_torch.config import load_config
    from leccr_torch.data import native_tokenizer
    from leccr_torch.data.synthetic import _WORDS_EN, _WORDS_T
    from leccr_torch.data.tokenizers import (
        UnigramTokenizer,
        WordPieceTokenizer,
        write_tiny_wordpiece_vocab,
    )
    from leccr_torch.eval.retrieval import pairwise_scores
    from leccr_torch.models.clip import CLIP_VARIANTS, interpolate_pos_embed
    from leccr_torch.models.leccr import LECCRModel
    from leccr_torch.models.weights import (
        export_reference_state_dict,
        load_initial_checkpoint,
        save_reference_checkpoint,
    )
    from leccr_torch.serve import Embedder
    from leccr_torch.train.trainer import Trainer

    def cpu_state(model):
        return {k: v.detach().cpu() for k, v in model.state_dict().items()}

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    fields = {}
    try:
        cfg = load_config(str(ROOT / "configs" / "multi30k_en_xlmr.yaml"))
        set_options(cfg, CHECKPOINT_OPTIONS)
        derived = tmp / "multi30k_en_xlmr.yaml"
        derived.write_text(yaml.safe_dump(cfg.to_dict()))
        out = tmp / "run"

        # 1. a reference-format file
        source = LECCRModel(cfg.model, seed=seed)
        want = cpu_state(source)
        ref = tmp / "checkpoint_best.pth"
        t0 = time.perf_counter()
        sd = export_reference_state_dict(source)
        sd.update({k: torch.ones(s) for k, s in DEAD_KEYS.items()})
        save_reference_checkpoint(sd, str(ref))
        fields.update(reference_bytes=ref.stat().st_size,
                      reference_tensors=len(sd),
                      reference_write_s=time.perf_counter() - t0)
        del source, sd

        # 2. import and train through the entry point
        seen = {}
        original = Trainer.load_initial_checkpoint

        def spy(self, path):
            t = time.perf_counter()
            report = original(self, path)
            torch.cuda.synchronize()
            seen.update(import_s=time.perf_counter() - t, report=report,
                        trainer=self, losses=[],
                        equal=state_equal(cpu_state(self.state.model), want))
            step_run = self.state.train_step.run

            def run_noted(batch, step_no):
                values = step_run(batch, step_no)
                seen["losses"].append(values)
                return values

            self.state.train_step.run = run_noted
            return report

        Trainer.load_initial_checkpoint = spy
        reset_counts()
        t0 = time.perf_counter()
        try:
            run.main(["--task", "itr_caption", "--config", str(derived),
                      "--output_dir", str(out), "--checkpoint", str(ref)])
        finally:
            Trainer.load_initial_checkpoint = original
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches, tc = step_counts(), tc_counts()
        kernel1 = kernel1_counts("the checkpoint phase's evals")
        tr, report = seen["trainer"], seen["report"]
        if not seen["equal"]:
            raise AssertionError("the imported parameters are not the "
                                 "source model's bit for bit")
        if (sorted(report.unused) != sorted(DEAD_KEYS)
                or report.issues != [f"unused: {k}" for k in report.unused]
                or sorted(report.grafted) != sorted(want)):
            raise AssertionError(f"import report: {report.issues[:8]}, "
                                 f"{len(report.grafted)} grafted")
        steps = tr.state.step
        epochs = cfg.train.schedular.epochs
        eval_batches = epochs * sum(
            math.ceil(len(ds) / cfg.train.batch_size_test)
            for split in (tr.val_ds, tr.test_ds) for ds in split.values())
        want_launches = tuple(n * steps for n in FLAGSHIP_STEP_LAUNCHES)
        if (steps != epochs * tr.steps_per_epoch or launches != want_launches
                or tc != launches[:2]):
            raise AssertionError(f"{steps} steps launched kernels 2-11 "
                                 f"{launches} ({tc} wgmma), want "
                                 f"{want_launches}")
        if kernel1["all"] != launches_per_batch(cfg) * eval_batches:
            raise AssertionError(f"kernel 1 launched {kernel1} for "
                                 f"{eval_batches} eval batches")
        losses = torch.stack(seen["losses"])
        if len(losses) != steps or not torch.isfinite(losses).all():
            raise AssertionError(f"losses: {losses}")
        later = [s for t in tr.timing for s in t["step_s"][1:]]
        fields.update(
            import_s=seen["import_s"], fit_s=fit_s, steps=steps,
            host_fed_ms_per_step=statistics.median(later) * 1e3,
            tokenizer=type(tr.tokenizer).__name__,
            tokenizer_native=tr.train_loader.native,
            launches=dict(zip(STEP_COUNTERS, launches)),
            kernel1_launches=kernel1, eval_batches=eval_batches,
            losses_first=losses[0].tolist(), losses_last=losses[-1].tolist())

        # 3. export, then import into a fresh model
        trained = cpu_state(tr.state.model)
        unigram = Path(tr.cfg.data.text_vocab)
        del tr, seen
        torch.cuda.empty_cache()
        (step_file,) = (out / "checkpoints").glob("step_*.pt")
        exported = tmp / "exported.pth"
        t0 = time.perf_counter()
        run.main(["--task", "export", "--config", str(derived),
                  "--checkpoint", str(step_file), "--export_path",
                  str(exported)])
        export_s = time.perf_counter() - t0
        fresh = LECCRModel(cfg.model, seed=seed + 1)
        t0 = time.perf_counter()
        back = load_initial_checkpoint(str(exported), fresh)
        torch.cuda.synchronize()
        reimport_s = time.perf_counter() - t0
        if back.issues or not state_equal(cpu_state(fresh), trained):
            raise AssertionError(f"export + import: {back.issues[:8]}")
        del fresh
        fields.update(export_s=export_s, export_bytes=exported.stat().st_size,
                      reimport_s=reimport_s)

        # 4. serve the exported weights with the Unigram tokenizer
        serve_cfg = load_config(str(derived))
        serve_cfg.data.text_vocab = str(unigram)
        serve_cfg.output_dir = str(tmp / "serve")
        emb = Embedder.from_config(serve_cfg, checkpoint=str(exported))
        if not isinstance(emb.tokenizer, UnigramTokenizer):
            raise AssertionError(f"serving tokenizer {emb.tokenizer}")
        rs = np.random.RandomState(seed)
        res = serve_cfg.model.vision.image_res
        g = torch.Generator(device="cuda").manual_seed(seed)
        images = torch.randint(0, 256, (256, res, res, 3), dtype=torch.uint8,
                               device="cuda", generator=g)
        words = _WORDS_EN + _WORDS_T
        captions = [" ".join(rs.choice(words, 12)) for _ in range(256)]
        queries = [" ".join(rs.choice(words, n)) for n in (3, 6, 9)]
        reset_counts()
        t0 = time.perf_counter()
        index = emb.build_image_index(images, captions)
        hits = emb.search_texts(queries, index, k=10)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        serve_kernel1 = kernel1_counts("the checkpoint phase's serving")
        if serve_kernel1["all"] != launches_per_batch(serve_cfg) * 4:
            raise AssertionError(f"serving launched kernel 1 {serve_kernel1}")
        # the queries as search_texts embeds them (one batch padded with
        # ""), scored by the same fixed-order product
        padded = queries + [""] * (emb.batch_size - len(queries))
        dense = pairwise_scores(torch.from_numpy(
            emb.embed_texts(padded)).cuda(), index.feats)[:len(queries)]
        for q, row in enumerate(hits):
            for rank, (item, score) in enumerate(row):
                above = int((dense[q] > score).sum())
                tied = int((dense[q] >= score).sum())
                if not (above <= rank < tied) or abs(
                        dense[q, int(item)].item() - score) > 0.0:
                    raise AssertionError(f"query {q} rank {rank}: {item} "
                                         f"{score}, {above} above")
        fields.update(serve_s=serve_s, serve_kernel1=serve_kernel1,
                      top_hits=[row[0] for row in hits])
        del emb, index
        torch.cuda.empty_cache()

        # 5. an OpenAI archive into the flagship with the CLIP captions
        clip_cfg = load_config(str(ROOT / "configs" / "multi30k_all.yaml"))
        set_options(clip_cfg, CHECKPOINT_OPTIONS)
        merges = tmp / "merges.txt"
        merges.write_text("\n".join(CLIP_MERGES) + "\n")
        clip_cfg.model.caption_encoder_name = "clip"
        clip_cfg.data.clip_bpe_vocab = str(merges)
        clip_cfg.output_dir = str(tmp / "clip")
        variant = CLIP_VARIANTS[clip_cfg.model.vision.variant]
        openai = tmp / "ViT-B-32.pt"
        osd = openai_clip_state_dict(variant, seed)
        torch.save(osd, openai)
        trainer = Trainer(clip_cfg)
        t0 = time.perf_counter()
        clip_report = trainer.load_initial_checkpoint(str(openai))
        openai_import_s = time.perf_counter() - t0
        model = trainer.state.model
        grid = clip_cfg.model.vision.image_res // variant.patch_size
        pos_want = interpolate_pos_embed(
            osd["visual.positional_embedding"].float(), grid)
        if not torch.equal(model.vision_tower.positional_embedding.cpu(),
                           pos_want):
            raise AssertionError("the position table is not "
                                 "interpolate_pos_embed of the file's")
        tower = cpu_state(model.clip_text_tower)
        if not torch.equal(tower["token_embedding.weight"],
                           osd["token_embedding.weight"].float()):
            raise AssertionError("the CLIP text tower was not loaded")
        proj = model.vision_tower.proj.detach().clone()
        clip_losses = []
        clip_run = trainer.state.train_step.run

        def clip_run_noted(batch, step_no):
            clip_losses.append(clip_run(batch, step_no))
            return clip_losses[-1]

        trainer.state.train_step.run = clip_run_noted
        reset_counts()
        trainer.train_epoch(0)
        torch.cuda.synchronize()
        clip_launches = step_counts()
        clip_steps = len(clip_losses)
        if clip_launches != tuple(n * clip_steps for n in
                                  (24, 24) + (0,) * 8):
            raise AssertionError(f"{clip_steps} steps with the CLIP caption "
                                 f"encoder launched {clip_launches}")
        values = torch.stack(clip_losses)
        if clip_steps != 2 or not torch.isfinite(values).all():
            raise AssertionError(f"CLIP-caption losses {values}")
        if not state_equal(cpu_state(model.clip_text_tower), tower):
            raise AssertionError("the CLIP text tower moved")
        if torch.equal(model.vision_tower.proj, proj):
            raise AssertionError("the vision tower did not train")
        fields.update(openai_bytes=openai.stat().st_size,
                      openai_import_s=openai_import_s,
                      openai_issues=clip_report.issues[:8],
                      clip_caption_launches=dict(zip(STEP_COUNTERS,
                                                     clip_launches)),
                      clip_caption_losses=values[-1].tolist())
        del trainer, model
        torch.cuda.empty_cache()

        # 6. native against Python tokenizers
        rs = np.random.RandomState(seed)
        texts = [" ".join(rs.choice(words, rs.randint(3, 30)))
                 for _ in range(NATIVE_TEXTS)]
        vocab = tmp / "vocab.txt"
        write_tiny_wordpiece_vocab(str(vocab), words)
        rates = {}
        for name, py in (("wordpiece", WordPieceTokenizer(str(vocab))),
                         ("unigram", UnigramTokenizer(str(unigram)))):
            native = native_tokenizer.native_counterpart(py)
            if native is None:
                raise AssertionError(f"the native {name} tokenizer did "
                                     f"not build")
            got = {}
            for kind, tok in (("python", py), ("native", native)):
                t0 = time.perf_counter()
                got[kind] = tok.encode(texts, 64)
                rates[f"{name}_{kind}_texts_per_s"] = (
                    len(texts) / (time.perf_counter() - t0))
            if not all(np.array_equal(a, b) for a, b in zip(
                    got["python"], got["native"])):
                raise AssertionError(f"native {name} ids differ")
        emit("checkpoint", card=card_line,
             config="configs/multi30k_en_xlmr.yaml",
             options=CHECKPOINT_OPTIONS, **fields, native_texts=len(texts),
             **rates)
        return launches, kernel1["all"] + serve_kernel1["all"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def dense_ranks(img, txt, txt2img, img2txt, slots=None, alpha=0.9,
                block: int = 256):
    """(i2t, t2i) ranks by a dense count over the streaming ranker's own
    block products (`pairwise_scores` of the same 256-row blocks, so the
    same bits), fused as the ranker fuses them: none without `slots`, else
    the double-sim's min-max blend.  img2txt: a dict of equal-length
    lists."""
    import numpy as np
    import torch

    from leccr_torch.eval.retrieval import pairwise_scores

    n_img, n_txt = img.shape[0], txt.shape[0]
    pad = (-n_img) % block

    def blocks(x):
        x = torch.nn.functional.pad(x, (0, 0) * (x.dim() - 1) + (0, pad))
        return [x[r:r + block] for r in range(0, n_img + pad, block)]

    s = torch.cat([pairwise_scores(b, txt) for b in blocks(img)])[:n_img]
    if slots is not None:
        c = torch.cat([pairwise_scores(b.reshape(-1, b.shape[-1]), txt).view(
            b.shape[0], b.shape[1], n_txt).amax(dim=1)
            for b in blocks(slots)])[:n_img]
        sa = 1.0 / torch.clamp_min(s.max() - s.min(), 1e-12)
        ca = 1.0 / torch.clamp_min(c.max() - c.min(), 1e-12)
        a0, a1 = alpha * sa, alpha * (-s.max() * sa)
        b0, b1 = (1.0 - alpha) * ca, (1.0 - alpha) * (-c.max() * ca)
        s = s * a0 + a1 + c * b0 + b1
    s = s.cpu().numpy()
    cols = np.arange(n_txt)
    g_t = s[txt2img, cols]
    t2i = ((s > g_t) | ((s == g_t)
                        & (np.arange(n_img)[:, None] > txt2img))).sum(0)
    gt = np.array([img2txt[i] for i in range(n_img)])
    g_i = np.take_along_axis(s, gt, axis=1)[:, :, None]
    i2t = ((s[:, None, :] > g_i) | ((s[:, None, :] == g_i)
                                    & (cols > gt[:, :, None]))
           ).sum(-1).min(1)
    return i2t, t2i


def video_phase(card_line: str = "", seed: int = 0):
    """The video path at configs/msrvtt.yaml's widths, uncut: temporal tower
    over 4096-d frames (1 layer, 8 heads, 32 frames), mBERT-base (119 547 x
    768, 12 layers), 2 slots, caption interaction 3/2/2 at width 4096 (Dh =
    512), bf16 on f32 masters.  Cut only in data and length (VIDEO_*):
    1. kernel 1 on its wide-head bodies against its plain version at
       VIDEO_SHAPES (timed beside its bound, the plain version and SDPA;
       two calls bit for bit) and VIDEO_EDGE_SHAPES, bf16 and f32, with key
       padding and a fully padded row (`kernel_phase`), and with a padded
       first key split or warp range (`wide_padded_range_checks`);
    2. `python -m leccr_torch.run --task vtr_caption` on a derived yaml
       over a synthetic MSR-VTT-layout set that the port's
       `make_video_dataset` writes in a temporary directory (removed
       after): 4 steps at bs128, then the double-sim eval of val and test
       (1000 videos x 5 captions each) and the epoch's checkpoint.
       Kernels 2/3 must launch VIDEO_STEP_LAUNCHES a step (all on the
       wgmma variant) and kernel 1 launches_per_batch() an eval
       batch, on its wide bodies only (`video_kernel1_counts`); finite
       losses and sumR;
    3. the test split evaluated again with embed_texts, embed_images and
       the ranker timed alone (the images from the eval device cache), its
       minmax ranks equal a dense count over the same block products
       (`dense_ranks`); then one more step under the profiler (device
       time by kernel, busy share of the host-fed step);
    4. an Embedder at the same widths (seeded random weights) indexes
       VIDEO_SERVE_VIDEOS videos of 2-32 frames (`build_video_index`) and
       answers 5 queries with fusion="minmax": kernel 1 launches_per_batch()
       an index batch on its wide bodies; each hit's rank and score
       agree with a dense count of the same scores;
    5. `--task build_index` of the test split from the run's checkpoint:
       kernel 1 launches_per_batch() a batch of 64, wide bodies only; the
       save loaded back answers search_texts(fusion="minmax").
    Returns (kernel 1 rows at the video shapes, kernel 2/3 launches of 2,
    kernel 1 counts of 2-5)."""
    import gc
    import shutil
    import statistics
    import tempfile

    import numpy as np
    import torch
    import yaml

    from leccr_torch import run
    from leccr_torch.config import load_config
    from leccr_torch.data.pipeline import device_prefetch
    from leccr_torch.data.synthetic import (
        _WORDS_EN,
        _WORDS_T,
        make_video_dataset,
    )
    from leccr_torch.serve import Embedder, _search_scores, load_index
    from leccr_torch.train import trainer as trainer_module
    from leccr_torch.train.trainer import Trainer

    card_line = card_line or card()
    shapes = kernel_phase(dh=VIDEO_DH, shapes=tuple(VIDEO_SHAPES),
                          edges=tuple(VIDEO_EDGE_SHAPES),
                          phase="video_kernel")
    for r in shapes:
        if r["body"] != VIDEO_BODIES[(r["lq"], r["lk"])]:
            raise AssertionError(f"kernel 1 at the video shape {r['lq']}x"
                                 f"{r['lk']} took the {r['body']} body")
    wide_padded_range_checks()
    vatex_kernel1 = vatex_check(card_line, seed)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_video_"))
    try:
        cfg = load_config(str(ROOT / "configs" / "msrvtt.yaml"))
        vision = cfg.model.vision
        t0 = time.perf_counter()
        data = make_video_dataset(
            str(tmp / "msrvtt"), n_train=VIDEO_TRAIN_CLIPS,
            n_eval=VIDEO_EVAL_VIDEOS, caps_per_video=VIDEO_EVAL_CAPTIONS,
            feat_dim=vision.frame_feat_dim,
            frames_per_video=vision.max_frames, seed=seed)
        for rel in data.train_file:  # one caption a training clip
            path = Path(data.root_dir) / rel
            path.write_text("\n".join(
                line for line in path.read_text().splitlines()
                if line.split(" ", 1)[0].endswith("#0")))
        data_s = time.perf_counter() - t0
        for field in ("root_dir", "train_file", "val_file", "test_file",
                      "image_root", "generated_caption_dir", "text_vocab"):
            setattr(cfg.data, field, getattr(data, field))
        cfg.train.schedular.epochs = 1
        cfg.train.seed = seed
        derived = tmp / "msrvtt.yaml"
        derived.write_text(yaml.safe_dump(cfg.to_dict()))
        out = tmp / "run"

        # 2. train and evaluate through the entry point
        seen = {"losses": [], "eval_s": []}
        original_fit = Trainer.fit

        def fit_spy(self, evaluate_only=False):
            seen["trainer"] = self
            step_run, evaluate = self.state.train_step.run, self.evaluate

            def run_noted(batch, step_no):
                values = step_run(batch, step_no)
                seen["losses"].append(values)
                return values

            def evaluate_timed(dataset):
                t = time.perf_counter()
                metrics = evaluate(dataset)
                torch.cuda.synchronize()
                seen["eval_s"].append(time.perf_counter() - t)
                return metrics

            self.state.train_step.run = run_noted
            self.evaluate = evaluate_timed
            return original_fit(self, evaluate_only)

        Trainer.fit = fit_spy
        # earlier phases' trainers sit in reference cycles (their spied
        # step functions): collect them, or their tensors join this peak
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        try:
            run.main(["--task", "vtr_caption", "--config", str(derived),
                      "--output_dir", str(out)])
        finally:
            Trainer.fit = original_fit
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        launches, tc = step_counts(), tc_counts()
        tr = seen["trainer"]
        steps = tr.state.step
        bs_test = cfg.train.batch_size_test
        eval_batches = sum(math.ceil(len(ds) / bs_test)
                           for split in (tr.val_ds, tr.test_ds)
                           for ds in split.values())
        fit_kernel1 = video_kernel1_counts("the video fit's evals", cfg,
                                           eval_batches)
        want = tuple(n * steps for n in VIDEO_STEP_LAUNCHES)
        if (steps != VIDEO_TRAIN_CLIPS // cfg.train.batch_size_train
                or launches != want or tc != launches[:2]):
            raise AssertionError(f"{steps} video steps launched kernels 2-11 "
                                 f"{launches} ({tc} wgmma), want {want}")
        if fit_kernel1["all"] != launches_per_batch(cfg) * eval_batches:
            raise AssertionError(f"kernel 1 launched {fit_kernel1} for "
                                 f"{eval_batches} embed_images batches")
        losses = torch.stack(seen["losses"])
        if len(losses) != steps or not torch.isfinite(losses).all():
            raise AssertionError(f"video losses: {losses}")
        records = [json.loads(line) for line in
                   (out / "log.txt").read_text().splitlines()]
        lang = next(iter(tr.test_ds))
        sumr = records[0][f"{lang}_test_sumr_sum"]
        if not math.isfinite(sumr):
            raise AssertionError(f"log.txt records {records}")
        later = [x for t in tr.timing for x in t["step_s"][1:]]
        step_ms = statistics.median(later) * 1e3

        # 3. the test split again, each part timed alone
        ds = tr.test_ds[lang]
        model = tr.eval_model()
        times = {"embed_texts_s": 0.0, "embed_images_s": 0.0,
                 "ranks_s": 0.0}

        def timed(key, fn):
            def call(*args, **kwargs):
                torch.cuda.synchronize()
                t = time.perf_counter()
                result = fn(*args, **kwargs)
                torch.cuda.synchronize()
                times[key] += time.perf_counter() - t
                return result
            return call

        ranker = trainer_module.retrieval_ranks
        model.embed_texts = timed("embed_texts_s", model.embed_texts)
        model.embed_images = timed("embed_images_s", model.embed_images)
        trainer_module.retrieval_ranks = timed("ranks_s", ranker)
        reset_counts()
        t0 = time.perf_counter()
        try:
            metrics = tr.evaluate(ds)
        finally:
            del model.embed_texts, model.embed_images
            trainer_module.retrieval_ranks = ranker
        eval_s = time.perf_counter() - t0
        eval_kernel1 = video_kernel1_counts(
            "the video eval", cfg, math.ceil(len(tr.test_ds[lang]) / bs_test))
        if any(step_counts()):
            raise AssertionError("the video eval launched training kernels")
        img, img_slots, txt = tr.embed_split(ds)
        i2t, t2i = ranker(img, txt, ds.index.txt2img, ds.index.img2txt,
                          slots=img_slots, fusion="minmax",
                          alpha=cfg.train.eval_alpha)
        t2i_gt = ds.index.txt2img
        want_i2t, want_t2i = dense_ranks(
            img, txt, np.array([t2i_gt[t] for t in range(len(t2i_gt))]),
            ds.index.img2txt, img_slots, cfg.train.eval_alpha)
        if not (np.array_equal(i2t, want_i2t)
                and np.array_equal(t2i, want_t2i)):
            raise AssertionError("the double-sim ranks differ from the "
                                 "dense count")
        if len(metrics) != 13 or not all(math.isfinite(v)
                                         for v in metrics.values()):
            raise AssertionError(f"bad video metrics {metrics}")
        # one more step, on a batch on the card, under the profiler
        batches = device_prefetch(tr.train_loader.epoch(0), tr.device)
        profile_step(tr.state.train_step, next(batches), steps, step_ms,
                     "video_train_step_profile")
        batches.close()
        n_params = sum(p.numel() for p in tr.state.model.parameters())
        ckpt = sorted((out / "checkpoints").glob("step_*.pt"))
        fields = dict(
            data_s=data_s, run_s=run_s, steps=steps,
            host_fed_ms_per_step=step_ms,
            host_fed_pairs_per_s=cfg.train.batch_size_train / step_ms * 1e3,
            step_s=[t["step_s"] for t in tr.timing],
            loader_wait_s=[t["wait_s"] for t in tr.timing],
            fit_eval_s=seen["eval_s"], eval_s=eval_s, **times,
            eval_batches=eval_batches, peak_mem_gb=peak_gb,
            checkpoint_bytes=ckpt[-1].stat().st_size if ckpt else None,
            params=n_params, launches=dict(zip(STEP_COUNTERS, launches)),
            launches_per_step=dict(zip(STEP_COUNTERS, VIDEO_STEP_LAUNCHES)),
            tc_launches=dict(zip(TC_COUNTERS, tc)),
            kernel1_fit=fit_kernel1, kernel1_eval=eval_kernel1,
            losses_first=losses[0].tolist(), losses_last=losses[-1].tolist(),
            sumr_sum=sumr, metrics=metrics)
        del tr, model, img, img_slots, txt
        seen.clear()
        torch.cuda.empty_cache()

        # 4. serving
        serve_cfg = load_config(str(derived))
        serve_cfg.output_dir = ""  # seeded random weights
        emb = Embedder.from_config(serve_cfg, seed=seed, device="cuda",
                                   batch_size=64)
        rs = np.random.RandomState(seed)
        frames = [rs.randn(rs.randint(2, vision.max_frames + 1),
                           vision.frame_feat_dim).astype(np.float32)
                  for _ in range(VIDEO_SERVE_VIDEOS)]
        words = _WORDS_EN + _WORDS_T
        captions = [" ".join(rs.choice(words, 12))
                    for _ in range(VIDEO_SERVE_VIDEOS)]
        queries = [" ".join(rs.choice(words, n)) for n in (3, 5, 6, 8, 9)]
        reset_counts()
        t0 = time.perf_counter()
        index = emb.build_video_index(frames, captions)
        torch.cuda.synchronize()
        index_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        hits = emb.search_texts(queries, index, k=10, fusion="minmax")
        search_s = time.perf_counter() - t0
        n_batches = math.ceil(VIDEO_SERVE_VIDEOS / emb.batch_size)
        serve_kernel1 = video_kernel1_counts("video serving", serve_cfg,
                                             n_batches)
        if serve_kernel1["all"] != launches_per_batch(serve_cfg) * n_batches:
            raise AssertionError(f"video serving launched kernel 1 "
                                 f"{serve_kernel1}")
        if not (torch.isfinite(index.feats).all()
                and torch.isfinite(index.slots).all()):
            raise AssertionError("non-finite video index")
        # the queries as search_texts embeds them, fused by the same scores
        padded = queries + [""] * (emb.batch_size - len(queries))
        q = torch.from_numpy(emb.embed_texts(padded)).to(index.feats.device)
        valid = torch.arange(emb.batch_size, device=q.device) < len(queries)
        dense = _search_scores(q, index, valid, "minmax", 0.9)[:len(queries)]
        for qi, row in enumerate(hits):
            for rank, (item, score) in enumerate(row):
                above = int((dense[qi] > score).sum())
                tied = int((dense[qi] >= score).sum())
                if not (above <= rank < tied) or (
                        dense[qi, int(item)].item() != score):
                    raise AssertionError(f"query {qi} rank {rank}: {item} "
                                         f"{score}, {above} above")
        fields.update(serve_videos=VIDEO_SERVE_VIDEOS, serve_index_s=index_s,
                      serve_search_s=search_s, serve_kernel1=serve_kernel1,
                      top_hits=[row[0] for row in hits])
        del emb, index
        torch.cuda.empty_cache()

        # 5. --task build_index of the test split from the run's checkpoint
        reset_counts()
        t0 = time.perf_counter()
        run.main(["--task", "build_index", "--config", str(derived),
                  "--output_dir", str(out), "--index", str(tmp / "index")])
        build_s = time.perf_counter() - t0
        n_batches = math.ceil(len(ds) / 64)
        build_kernel1 = video_kernel1_counts("video build_index", cfg,
                                             n_batches)
        if build_kernel1["all"] != launches_per_batch(cfg) * n_batches:
            raise AssertionError(f"video build_index launched kernel 1 "
                                 f"{build_kernel1}")
        index = load_index(str(tmp / "index"), "cuda")
        serve_cfg = load_config(str(derived))
        serve_cfg.output_dir = str(out)  # the run's newest checkpoint
        emb = Embedder.from_config(serve_cfg, device="cuda", batch_size=64)
        t0 = time.perf_counter()
        hits = emb.search_texts(queries, index, k=10, fusion="minmax")
        search_s = time.perf_counter() - t0
        ids = set(index.ids)
        for row in hits:
            scores = [s for _, s in row]
            if (len(row) != 10 or not all(i in ids for i, _ in row)
                    or scores != sorted(scores, reverse=True)
                    or not all(math.isfinite(s) for s in scores)):
                raise AssertionError(f"bad video search result {row}")
        if (index.n_valid != len(ds) or index.slots is None
                or not torch.isfinite(index.feats).all()):
            raise AssertionError("bad video index from build_index")
        fields.update(build_index_s=build_s, build_index_kernel1=build_kernel1,
                      build_index_search_s=search_s,
                      build_index_top_hits=[row[0] for row in hits])
        del emb, index
        torch.cuda.empty_cache()
        emit("video", card=card_line, config="configs/msrvtt.yaml",
             cuts={"train_clips": VIDEO_TRAIN_CLIPS, "captions_a_clip": 1,
                   "epochs": 1, "eval_videos_a_split": VIDEO_EVAL_VIDEOS,
                   "eval_captions_a_video": VIDEO_EVAL_CAPTIONS,
                   "note": "msrvtt10ktest is 2990 videos x 20 captions; "
                           "frames and captions synthetic"},
             batch=cfg.train.batch_size_train, **fields)
        return shapes, launches, {"fit": fit_kernel1, "eval": eval_kernel1,
                                  "serve": serve_kernel1,
                                  "build_index": build_kernel1,
                                  "vatex": vatex_kernel1}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


VATEX_VIDEOS = 64  # configs/vatex.yaml's batch_size_test


def vatex_check(card_line: str, seed: int = 0) -> dict:
    """One embed_images batch of configs/vatex.yaml's model, uncut, bf16 on
    f32 masters (1024-d frames at 8 heads: Dh = 128, kernel 1's small
    bodies): every kernel 1 call of the batch held to its plain version on
    the same inputs with kernel_phase's bf16 tolerance (every element
    within 1e-5 + 1 bf16 ulp).  Returns kernel 1's counts."""
    import torch

    from leccr_torch.config import load_config
    from leccr_torch.models.leccr import LECCRModel
    from leccr_torch.ops import attention
    from leccr_torch.ops.fused_cross_attention import (
        fused_cross_attention_reference,
    )

    cfg = load_config(str(ROOT / "configs" / "vatex.yaml"))
    mcfg = cfg.model
    model = LECCRModel(mcfg, device="cuda", seed=seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    n, frames = VATEX_VIDEOS, mcfg.vision.max_frames
    length = cfg.data.max_tokens
    valid = torch.randint(1, frames + 1, (n, 1), device="cuda", generator=g)
    valid[0] = frames
    words = torch.randint(1, length + 1, (n, 1), device="cuda", generator=g)
    words[0] = length
    caption_mask = (torch.arange(length, device="cuda")[None] < words).int()
    batch = {
        "vision": torch.randn((n, frames, mcfg.vision.frame_feat_dim),
                              device="cuda", generator=g),
        "vision_mask": torch.arange(frames, device="cuda")[None] < valid,
        "caption_ids": torch.randint(1, mcfg.text.vocab_size, (n, length),
                                     device="cuda", generator=g)
        * caption_mask,
        "caption_mask": caption_mask,
    }
    kernel, calls = attention.fused_cross_attention, []

    def checked(q, k, v, pad=None):
        out = kernel(q, k, v, pad)
        want = fused_cross_attention_reference(q, k, v, pad)
        diff = (out.float() - want.float()).abs()
        calls.append({"lq": q.shape[2], "lk": k.shape[2], "dh": q.shape[3],
                      "max_abs_err": diff.max().item(),
                      "ok": bool((diff <= 1e-5 + bf16_ulp(want)).all())})
        return out

    reset_counts()
    attention.fused_cross_attention = checked
    try:
        out = model.embed_images(batch)
    finally:
        attention.fused_cross_attention = kernel
    counts = kernel1_counts("the vatex embed_images batch")
    finite = all(bool(torch.isfinite(out[k]).all()) for k in ("feat", "slots"))
    if (counts["all"] != launches_per_batch(cfg) or len(calls) != counts["all"]
            or not finite or not all(c["ok"] for c in calls)):
        raise AssertionError(f"vatex embed_images: kernel 1 {counts}, calls "
                             f"{calls}, finite {finite}")
    emit("vatex_check", card=card_line, config="configs/vatex.yaml",
         dtype=mcfg.dtype, videos=n, frames=frames, caption_tokens=length,
         kernel1=counts, calls=calls,
         max_abs_err=max(c["max_abs_err"] for c in calls),
         tolerance="every element within 1e-5 + 1 bf16 ulp of the plain "
                   "version",
         params=sum(p.numel() for p in model.parameters()))
    del model
    torch.cuda.empty_cache()
    return counts


SERVE_IMAGES = 1000  # Multi30K's test2016
SERVE_REMOVED = 50
SERVE_CLIENTS = 32
SERVE_WINDOW_S = 10.0  # the sustained load each save serves, after warm-up


def serve_child(argv):
    """`python -m leccr_torch.run --task serve ... --port 0` in a child
    process, its output read on a thread: (process, queue of lines, None
    after the last)."""
    import queue
    import threading

    proc = subprocess.Popen(
        [sys.executable, "-m", "leccr_torch.run", "--task", "serve",
         "--port", "0", *argv], cwd=str(ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    lines: "queue.Queue" = queue.Queue()
    threading.Thread(target=lambda: [lines.put(x) for x in proc.stdout]
                     + [lines.put(None)], daemon=True).start()
    return proc, lines


def serving_url(proc, lines, what: str, timeout: float = 300) -> str:
    """The base url of a `serve_child` once it prints its '### serving on'
    line, within `timeout` s; a child that exits or stays silent is killed
    and raises."""
    import queue

    seen, deadline = [], time.monotonic() + timeout
    while True:
        try:
            line = lines.get(timeout=max(0.0, deadline - time.monotonic()))
        except queue.Empty:
            line = None
        if line is None:
            proc.kill()
            proc.wait(timeout=30)
            raise AssertionError(f"{what}: no '### serving on' line:\n"
                                 + "".join(seen[-30:]))
        seen.append(line)
        if line.startswith("### serving on "):
            return line.split()[3]


def http_json(url: str, body=None, timeout: float = 60):
    import urllib.request

    req = urllib.request.Request(
        url, data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def same_hits(got, want, what: str) -> None:
    """Scores within 1e-3; ids equal wherever the scores are more than
    1e-3 apart from every other score of the row."""
    for g_row, w_row in zip(got, want):
        if len(g_row) != len(w_row):
            raise AssertionError(f"{what}: {len(g_row)} hits, want "
                                 f"{len(w_row)}")
        w_s = [s for _, s in w_row]
        for j, ((gi, gs), (wi, ws)) in enumerate(zip(g_row, w_row)):
            gaps = [abs(ws - s) for i, s in enumerate(w_s) if i != j]
            if abs(gs - ws) > 1e-3 or (min(gaps, default=1) > 1e-3
                                       and gi != wi):
                raise AssertionError(f"{what}: hit {j} {gi, gs} vs "
                                     f"{wi, ws}")


def sustained_load(base: str, words, seed: int, window_s: float) -> dict:
    """SERVE_CLIENTS client threads, each sending fresh requests of 1-4
    queries of 2-8 words to base/search back to back until window_s s
    have passed: requests, queries, wall s (from the start to the last
    answer), requests/s and queries/s over that wall, client p50 / p95 /
    p99 ms over every request, and "last": each client's last (queries,
    answer rows).  Raises if a request failed or a client hung."""
    import threading

    import numpy as np

    lat = [[] for _ in range(SERVE_CLIENTS)]
    nq = [0] * SERVE_CLIENTS
    last = [None] * SERVE_CLIENTS
    failed = []
    t0 = time.perf_counter()
    end = t0 + window_s

    def client(i):
        rs = np.random.RandomState([seed, 1, i])
        try:
            while time.perf_counter() < end:
                queries = [" ".join(rs.choice(words, rs.randint(2, 9)))
                           for _ in range(rs.randint(1, 5))]
                t = time.perf_counter()
                r = http_json(base + "/search", {"queries": queries, "k": 10})
                lat[i].append(time.perf_counter() - t)
                if len(r["results"]) != len(queries):
                    raise AssertionError(f"{len(r['results'])} rows for "
                                         f"{len(queries)} queries")
                nq[i] += len(queries)
                last[i] = (queries, r["results"])
        except Exception as e:  # noqa: BLE001 - reported below
            failed.append(f"client {i}: {e!r}")

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(SERVE_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=max(0.0, end + 120 - time.perf_counter()))
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        failed.append("a client did not finish within 120 s of the window")
    if failed or None in last:
        raise AssertionError(f"sustained load on {base}: {failed}")
    every = np.array([x for xs in lat for x in xs]) * 1e3
    return {"window_s": window_s, "wall_s": wall, "requests": every.size,
            "queries": sum(nq), "requests_per_s": every.size / wall,
            "queries_per_s": sum(nq) / wall,
            "client_p50_ms": float(np.percentile(every, 50)),
            "client_p95_ms": float(np.percentile(every, 95)),
            "client_p99_ms": float(np.percentile(every, 99)),
            "last": last}


def dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.iterdir())


def serve_tasks_phase(card_line: str, checkpoint: str, seed: int = 0):
    """The serving tasks at the flagship's width (configs/multi30k_all.yaml,
    bf16) from `fit_phase`'s last checkpoint, through `leccr_torch.run.main`
    in this process (so the launch counts can be read), over a synthetic
    Multi30K-layout test split of SERVE_IMAGES images that build_datasets
    writes (FIT_OPTIONS, `synthetic_eval_images: SERVE_IMAGES`) in a
    temporary directory, removed after:
    1. `--task build_index` three times, f32, `--int8` and `--ivf
       --ivf_recall 0.95`: kernel 1 launches_per_batch() an image batch of
       serve_bs 64, on its small bodies only, none of kernels 2-11;
    2. `--task update_index --remove_ids` of SERVE_REMOVED items, then
       `--add_new` on each save: the add embeds exactly those items; on
       the f32 save the re-added rows are finite, unit-norm within 1e-2 and
       within 1e-2 of the rows they replace; on the int8 save every other
       row keeps its bytes and scales; the IVF save holds every item once;
    3. `--task serve --port 0` of each save, three child processes side by
       side: SERVE_CLIENTS client threads of 1-4 queries each (a warm-up
       burst, then the checked one), every
       result equal to an in-process `Embedder.search_texts` (or
       `search_texts_ivf`) on the same loaded save (`same_hits`),
       /healthz's index_size, /stats with fewer dispatches than requests
       and no error; then `sustained_load` of SERVE_WINDOW_S s, no
       request failed or shed and each client's last answer equal to
       the in-process search; SIGINT, then exit 0 within 30 s.
    Prints build s, embed s a batch, save and load s, bytes on disk, and
    over each window requests/s, queries/s, client p50 / p95 / p99
    latency and the dispatches' mean batch.  Returns kernel 1's counts."""
    import shutil
    import tempfile
    import threading

    import numpy as np
    import torch
    import yaml

    from leccr_torch import run
    from leccr_torch import serve as serve_module
    from leccr_torch import serve_ann
    from leccr_torch.config import load_config
    from leccr_torch.data.synthetic import _WORDS_EN, _WORDS_T
    from leccr_torch.serve import Embedder, load_index
    from leccr_torch.train.trainer import build_datasets

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_serve_"))
    children = []
    try:
        cfg = load_config(str(ROOT / "configs" / "multi30k_all.yaml"))
        set_options(cfg, {**FIT_OPTIONS,
                          "data.synthetic_eval_images": SERVE_IMAGES})
        cfg.output_dir = str(tmp / "run")
        t0 = time.perf_counter()
        build_datasets(cfg)  # writes the files, points cfg.data at them
        data_s = time.perf_counter() - t0
        derived = tmp / "multi30k_serve.yaml"
        derived.write_text(yaml.safe_dump(cfg.to_dict()))
        common = ["--config", str(derived), "--output_dir", str(tmp / "run"),
                  "--checkpoint", checkpoint]
        saves = {"f32": tmp / "f32", "int8": tmp / "int8", "ivf": tmp / "ivf"}
        flags = {"f32": [], "int8": ["--int8"],
                 "ivf": ["--ivf", "--ivf_recall", "0.95"]}
        timing = {"embed_s": [], "save_s": []}

        def spy(module, name, key):
            fn = getattr(module, name)

            def call(*args, **kwargs):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = fn(*args, **kwargs)
                torch.cuda.synchronize()
                timing[key].append(time.perf_counter() - t)
                return out
            setattr(module, name, call)
            return fn

        originals = [(run, "_embed_corpus", spy(run, "_embed_corpus",
                                                "embed_s")),
                     (serve_module, "save_index",
                      spy(serve_module, "save_index", "save_s")),
                     (serve_ann, "save_ivf",
                      spy(serve_ann, "save_ivf", "save_s"))]
        per_batch = launches_per_batch(cfg)
        counts, build_s = {}, {}
        try:
            for name, path in saves.items():
                reset_counts()
                t0 = time.perf_counter()
                run.main(["--task", "build_index", *common, "--index",
                          str(path), *flags[name]])
                build_s[name] = time.perf_counter() - t0
                counts[f"build_{name}"] = kernel1_counts(f"build_index {name}")
                if any(step_counts()):
                    raise AssertionError("build_index launched kernels 2-11")
                want = per_batch * math.ceil(SERVE_IMAGES / 64)
                if counts[f"build_{name}"]["all"] != want:
                    raise AssertionError(f"build_index {name} launched kernel "
                                         f"1 {counts[f'build_{name}']}, want "
                                         f"{want}")
            before = {name: (load_index(str(saves[name]), "cuda")
                             if name != "ivf" else
                             serve_ann.load_ivf(str(saves[name]), "cuda"))
                      for name in saves}
            ids = before["f32"].ids
            removed = [ids[i] for i in np.random.RandomState(seed).choice(
                len(ids), SERVE_REMOVED, replace=False)]
            update_s = {}
            for name, path in saves.items():
                t0 = time.perf_counter()
                run.main(["--task", "update_index", *common, "--index",
                          str(path), "--remove_ids", ",".join(removed)])
                reset_counts()
                run.main(["--task", "update_index", *common, "--index",
                          str(path), "--add_new"])
                update_s[name] = time.perf_counter() - t0
                counts[f"add_{name}"] = kernel1_counts(f"add_new {name}")
                want = per_batch * math.ceil(SERVE_REMOVED / 64)
                if counts[f"add_{name}"]["all"] != want:
                    raise AssertionError(f"add_new {name} launched kernel 1 "
                                         f"{counts[f'add_{name}']}, want "
                                         f"{want}")
        finally:
            for module, name, fn in originals:
                setattr(module, name, fn)
        t0 = time.perf_counter()
        after = {"f32": load_index(str(saves["f32"]), "cuda"),
                 "int8": load_index(str(saves["int8"]), "cuda"),
                 "ivf": serve_ann.load_ivf(str(saves["ivf"]), "cuda")}
        load_s = time.perf_counter() - t0
        gone = set(removed)
        old, new = before["f32"], after["f32"]
        pos = {i: j for j, i in enumerate(new.ids)}
        back = torch.tensor([pos[i] for i in removed], device="cuda")
        was = torch.tensor([ids.index(i) for i in removed], device="cuda")
        rows = new.feats[back]
        drift = (rows - old.feats[was]).abs().max().item()
        norm_err = (rows.norm(dim=-1) - 1).abs().max().item()
        if (sorted(new.ids) != sorted(ids) or not torch.isfinite(rows).all()
                or norm_err > 1e-2 or drift > 1e-2):
            raise AssertionError(f"re-added rows: norm {norm_err}, drift "
                                 f"{drift}")
        kept = [i for i in ids if i not in gone]
        o8, n8 = before["int8"], after["int8"]
        p8 = {i: j for j, i in enumerate(n8.ids)}
        ko = torch.tensor([ids.index(i) for i in kept], device="cuda")
        kn = torch.tensor([p8[i] for i in kept], device="cuda")
        for key in ("feats", "slots", "scale", "slot_scale"):
            if not torch.equal(getattr(o8, key)[ko], getattr(n8, key)[kn]):
                raise AssertionError(f"int8 rows changed their {key}")
        ivf = after["ivf"]
        placed = ivf.rows[ivf.valid]
        if (sorted(ivf.ids) != sorted(ids) or placed.numel() != len(ids)
                or placed.unique().numel() != len(ids)):
            raise AssertionError("the updated IVF index lost rows")
        del before, old, o8

        # 3. serve each save from a child process, side by side
        emb = Embedder.from_config(cfg, checkpoint=checkpoint, device="cuda",
                                   batch_size=64)
        rs = np.random.RandomState(seed)
        words = _WORDS_EN + _WORDS_T
        requests = [[" ".join(rs.choice(words, rs.randint(2, 9)))
                     for _ in range(rs.randint(1, 5))]
                    for _ in range(SERVE_CLIENTS)]
        t0 = time.perf_counter()
        for name, path in saves.items():
            children.append((name, *serve_child(
                [*common, "--index", str(path)])))
        urls = {name: serving_url(proc, lines, f"serve {name}")
                for name, proc, lines in children}
        start_s = time.perf_counter() - t0
        served = {}

        def burst(base):
            """SERVE_CLIENTS client threads at once: (answers, wall s)."""
            out = [None] * SERVE_CLIENTS

            def client(i):
                out[i] = http_json(base + "/search",
                                   {"queries": requests[i], "k": 10})

            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(SERVE_CLIENTS)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            return out, time.perf_counter() - t0

        for name, base in urls.items():
            burst(base)  # warm: the first burst's batch sizes are new
            out, wall = burst(base)
            if any(r is None for r in out):
                raise AssertionError(f"serve {name}: a client got no answer")
            index = after[name]
            for i, r in enumerate(out):
                want = (serve_ann.search_texts_ivf(emb, requests[i], index,
                                                   k=10)
                        if name == "ivf" else
                        emb.search_texts(requests[i], index, k=10))
                same_hits([[tuple(h) for h in row] for row in r["results"]],
                          want, f"serve {name} request {i}")
            health = http_json(base + "/healthz")
            stats = http_json(base + "/stats")
            if (health != {"ok": True, "index_size": len(ids)}
                    or stats["errors"] or not stats["dispatches"]
                    < stats["requests"] or "latency_p95_s" not in stats):
                raise AssertionError(f"serve {name}: {health} {stats}")
            load = sustained_load(base, words, seed, SERVE_WINDOW_S)
            for i, (queries, got) in enumerate(load.pop("last")):
                want = (serve_ann.search_texts_ivf(emb, queries, index, k=10)
                        if name == "ivf" else
                        emb.search_texts(queries, index, k=10))
                same_hits([[tuple(h) for h in row] for row in got], want,
                          f"serve {name} load client {i}")
            after_stats = http_json(base + "/stats")
            dispatches = after_stats["dispatches"] - stats["dispatches"]
            if (after_stats["errors"] or after_stats["rejected"]
                    or after_stats["requests"] - stats["requests"]
                    != load["requests"] or dispatches >= load["requests"]):
                raise AssertionError(f"serve {name} under load: {load} "
                                     f"{after_stats}")
            served[name] = {
                **load, "dispatches": dispatches,
                "mean_batch": (after_stats["dispatched_queries"]
                               - stats["dispatched_queries"]) / dispatches,
                "check_burst": {"wall_s": wall, "dispatches":
                                stats["dispatches"], "requests":
                                stats["requests"]},
                "stats": after_stats}
        for name, proc, _ in children:
            proc.send_signal(signal.SIGINT)
            try:
                rc = proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                raise AssertionError(f"serve {name} did not stop on SIGINT")
            if rc != 0:
                raise AssertionError(f"serve {name} exited {rc}")
        children.clear()
        batches = math.ceil(SERVE_IMAGES / 64)
        emit("serve_tasks", card=card_line, config="configs/multi30k_all.yaml",
             images=SERVE_IMAGES, removed=SERVE_REMOVED,
             clients=SERVE_CLIENTS, data_s=data_s, build_s=build_s,
             embed_s=timing["embed_s"],
             embed_s_per_batch=[s / batches for s in timing["embed_s"][:3]],
             save_s=timing["save_s"], load_s_all_three=load_s,
             update_s=update_s,
             bytes_on_disk={name: dir_bytes(path)
                            for name, path in saves.items()},
             ivf={"clusters": ivf.n_clusters, "capacity": ivf.capacity,
                  "nprobe": ivf.default_nprobe},
             readded_max_drift=drift, readded_max_norm_err=norm_err,
             serve_start_s=start_s, served=served, kernel1=counts)
        return counts
    finally:
        for _, proc, *_ in children:
            proc.kill()
            proc.wait(timeout=30)
        shutil.rmtree(tmp, ignore_errors=True)


INDEX_ROWS = 1_000_000  # the JAX module's production point: 1M rows, C = 4000
INDEX_SLOTS = 4
INDEX_DIM = 256
INDEX_CONCEPTS = 1000
INDEX_QUERIES = 64
INDEX_RECALL = 0.95


def span_ms(fn, iters: int = 5) -> float:
    """Median ms of fn() on the device's clock, each call alone between
    two CUDA events with the device idle before it: device time plus the
    host's gaps inside fn (a search's sorts and its host reads).  With
    iters > 1 a first, untimed call warms it up."""
    import statistics

    import torch

    if iters > 1:
        fn()
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def clustered_rows(g, cents, n: int, slots: int = 0):
    """L2-normalized rows around random concept directions, as
    tests/test_serve_ann.py draws them (concept + spread · noise), the
    spread scaled by √(32 / E) to keep that test's angle to the concept at
    E = 32; with `slots`, [n, slots, E] around each row's concept."""
    import torch

    e = cents.shape[1]
    spread = 0.15 * math.sqrt(32 / e)
    pick = torch.randint(0, cents.shape[0], (n,), device=cents.device,
                         generator=g)
    shape = (n, slots, e) if slots else (n, e)
    base = cents[pick][:, None] if slots else cents[pick]
    x = base + spread * torch.randn(shape, device=cents.device, generator=g)
    return x / x.norm(dim=-1, keepdim=True)


INT8_CARD_SHAPES = [(3, 13, 36), (17, 1003, 256), (64, 1000, 256)]


def int8_matches_cpu(b: int, n: int, e: int, slots: int = 3) -> None:
    """The int8 serving path on the card against the CPU at [b, e] queries
    and [n, e] rows ([n, slots, e] slots): quantization, `_int8_mm`'s sums
    and the dequantized scores bit for bit.  The shapes reach
    `torch._int_mm`'s CUDA rules (more than 16 rows, widths a multiple of
    8) through `_int8_mm`'s zero padding: b <= 16, n and e off a multiple
    of 8."""
    import torch

    from leccr_torch.serve import (
        _int8_mm,
        _int8_scores,
        _int8_slot_scores,
        _quantize_rows,
    )

    g = torch.Generator().manual_seed(b * n + e)
    q, f, sl = (torch.nn.functional.normalize(
        torch.randn(*shape, generator=g), dim=-1)
        for shape in ((b, e), (n, e), (n, slots, e)))
    f8, fs = _quantize_rows(f)
    s8, ss = _quantize_rows(sl)
    card = [x.cuda() for x in (q, f, f8, fs, sl, s8, ss)]
    qc, fc, f8c, fsc, slc, s8c, ssc = card
    pairs = {
        "quantize": (torch.cat([x.flatten().view(torch.uint8) for x in
                                (*_quantize_rows(fc), *_quantize_rows(slc))]),
                     torch.cat([x.flatten().view(torch.uint8) for x in
                                (f8, fs, s8, ss)])),
        "int8_mm": (_int8_mm(_quantize_rows(qc)[0], f8c),
                    _quantize_rows(q)[0].int() @ f8.int().T),
        "scores": (_int8_scores(qc, f8c, fsc), _int8_scores(q, f8, fs)),
        "slot_scores": (_int8_slot_scores(qc, s8c, ssc),
                        _int8_slot_scores(q, s8, ss)),
    }
    for what, (got, want) in pairs.items():
        if not torch.equal(got.cpu(), want):
            raise AssertionError(f"int8 {what} at {(b, n, e)}: the card "
                                 f"differs from the CPU")


def index_scale_phase(card_line: str = "", seed: int = 0):
    """The serving index at scale, no model: INDEX_ROWS unit rows at E =
    INDEX_DIM with INDEX_SLOTS slots each around INDEX_CONCEPTS concepts
    (`clustered_rows`), the last row a copy of the first; C = 4·√N
    clusters.  Checks: the int8 path on the card equals the CPU's bit for
    bit at INT8_CARD_SHAPES (`int8_matches_cpu`); the IVF's full probe
    equals the exact search
    (scores within 1e-5, ids where untied); recall@10 at the calibrated
    nprobe reaches INDEX_RECALL on the calibration's sample (and on 64
    fresh queries, printed); int8 against f32 within 0.03 on the exact
    index (every score) and 5e-3 on the IVF (top-10 at the full probe);
    two builds from one seed give bit-identical centroids and packing;
    the two equal rows score bit for bit alike (f32 and int8, none and
    minmax).  Timed (CUDA events, median of 5, INDEX_QUERIES pre-embedded
    queries): quantize_index, k-means, _pack, calibrate_nprobe, and the
    searches: exact f32 (pairwise_scores + top-10) beside torch.matmul of
    the same product (the library yardstick), exact minmax, exact int8
    (none and minmax), IVF f32 and int8 at the calibrated nprobe."""
    import gc

    import numpy as np
    import torch

    from leccr_torch import serve_ann as sa
    from leccr_torch.eval.retrieval import pairwise_scores
    from leccr_torch.serve import (
        ImageIndex,
        _feat_scores,
        _search_scores,
        _top_k,
        quantize_index,
    )

    card_line = card_line or card()
    for shape in INT8_CARD_SHAPES:
        int8_matches_cpu(*shape)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    n, e, k = INDEX_ROWS, INDEX_DIM, 10
    n_clusters = int(4 * math.sqrt(n))
    g = torch.Generator(device="cuda").manual_seed(seed)
    t0 = time.perf_counter()
    with torch.inference_mode():
        cents = torch.randn(INDEX_CONCEPTS, e, device="cuda", generator=g)
        cents /= cents.norm(dim=-1, keepdim=True)
        feats = clustered_rows(g, cents, n)
        slots = torch.cat([clustered_rows(g, cents, n // 8, INDEX_SLOTS)
                           for _ in range(8)])
        feats[-1], slots[-1] = feats[0], slots[0]  # a tie
        q = clustered_rows(g, cents, INDEX_QUERIES)
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    index = ImageIndex(feats=feats, slots=slots,
                       ids=[str(i) for i in range(n)])
    valid = torch.ones(INDEX_QUERIES, dtype=torch.bool, device="cuda")
    times = {}

    def timed(key, fn, iters=1):
        times[key] = span_ms(fn, iters)

    with torch.inference_mode():
        timed("quantize_index_ms", lambda: quantize_index(index), 3)
        q8 = quantize_index(index)

        # two builds from one seed: one through build_ivf_index, one by
        # its parts, each part timed
        t0 = time.perf_counter()
        ivf = sa.build_ivf_index(index, n_clusters=n_clusters, seed=seed,
                                 device="cuda")
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        cent = [None]
        timed("kmeans_ms", lambda: cent.__setitem__(
            0, sa._kmeans(feats, n_clusters, 15, seed)))
        packing = [None]
        timed("pack_ms", lambda: packing.__setitem__(
            0, sa._pack(feats, cent[0], 1.3, 8)))
        rows, cap = packing[0]
        if not (torch.equal(cent[0], ivf.centroids) and cap == ivf.capacity
                and np.array_equal(np.maximum(rows, 0),
                                   ivf.rows.cpu().numpy())
                and np.array_equal(rows >= 0, ivf.valid.cpu().numpy())):
            raise AssertionError("two IVF builds from one seed differ")
        placed = ivf.rows[ivf.valid]
        if placed.numel() != n or placed.unique().numel() != n:
            raise AssertionError("the IVF did not pack every row once")
        calib = [None]
        timed("calibrate_nprobe_ms", lambda: calib.__setitem__(
            0, sa.calibrate_nprobe(ivf, target_recall=INDEX_RECALL)))
        nprobe, calib_recall = calib[0]
        if calib_recall < INDEX_RECALL or not 1 <= nprobe <= n_clusters:
            raise AssertionError(f"calibrated nprobe {nprobe} reads recall "
                                 f"{calib_recall}")
        ivf8 = sa.quantize_ivf(ivf)

        # exact search, f32: the fixed-order product and the library's
        def exact(idx, fusion):
            return _top_k(_search_scores(q, idx, valid, fusion, 0.9), k)

        timed("exact_f32_ms", lambda: exact(index, "none"), 5)
        timed("exact_f32_scores_ms",
              lambda: pairwise_scores(q, feats), 5)
        timed("matmul_scores_ms", lambda: torch.matmul(q, feats.T), 5)
        timed("exact_f32_minmax_ms", lambda: exact(index, "minmax"), 5)
        timed("exact_int8_ms", lambda: exact(q8, "none"), 5)
        timed("exact_int8_minmax_ms", lambda: exact(q8, "minmax"), 5)
        arrays, arrays8 = sa._ivf_arrays(ivf), sa._ivf_arrays(ivf8)
        timed("ivf_f32_ms", lambda: sa._ivf_topk(q, arrays, k, nprobe), 5)
        timed("ivf_int8_ms", lambda: sa._ivf_topk(q, arrays8, k, nprobe),
              5)

        # the full probe is the exact search
        es, ei = exact(index, "none")
        fs, fi = sa._ivf_topk(q, arrays, k, n_clusters)
        full_err = (fs - es).abs().max().item()
        untied = (es[:, :-1] - es[:, 1:]).abs() > 1e-6
        id_agree = (fi[:, :-1] == ei[:, :-1])[untied].float().mean().item()
        if full_err > 1e-5 or id_agree < 0.99:
            raise AssertionError(f"the full probe differs from the exact "
                                 f"search: {full_err}, ids {id_agree}")
        _, ai = sa._ivf_topk(q, arrays, k, nprobe)
        query_recall = np.mean([len(set(a) & set(b)) / k for a, b in zip(
            ai.cpu().numpy(), ei.cpu().numpy())])
        # int8 against f32
        int8_err = (_feat_scores(q, feats, None)
                    - _feat_scores(q, q8.feats, q8.scale)).abs().max().item()
        f8s, _ = sa._ivf_topk(q, arrays8, k, n_clusters)
        ivf_int8_err = (f8s - fs).abs().max().item()
        if int8_err > 0.03 or ivf_int8_err > 5e-3:
            raise AssertionError(f"int8 scores off: exact {int8_err}, IVF "
                                 f"{ivf_int8_err}")
        # the tie: rows 0 and n-1 are equal
        for idx in (index, q8):
            for fusion in ("none", "minmax"):
                s = _search_scores(q, idx, valid, fusion, 0.9)
                if not torch.equal(s[:, 0], s[:, -1]):
                    raise AssertionError(f"equal rows scored apart "
                                         f"({fusion}, int8 {idx.quantized})")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with torch.inference_mode():
        sharded_serve_phase(card_line, index, q8, q, valid)
    gb = lambda *xs: sum(x.numel() * x.element_size() for x in xs) / 1e9  # noqa: E731
    emit("index_scale", card=card_line, rows=n, dim=e, slots=INDEX_SLOTS,
         concepts=INDEX_CONCEPTS, queries=INDEX_QUERIES,
         clusters=n_clusters, capacity=ivf.capacity, nprobe=nprobe,
         calibration_recall=calib_recall, query_recall_at_nprobe=query_recall,
         int8_card_equals_cpu=INT8_CARD_SHAPES,
         full_probe_max_err=full_err, full_probe_id_agreement=id_agree,
         int8_max_err=int8_err, ivf_int8_max_err=ivf_int8_err,
         data_s=data_s, build_ivf_s=build_s, **times,
         exact_f32_vs_matmul=(times["exact_f32_scores_ms"]
                              / times["matmul_scores_ms"]),
         device_gb={"feats": gb(feats), "slots": gb(slots),
                    "int8": gb(q8.feats, q8.slots, q8.scale, q8.slot_scale),
                    "ivf": gb(*[x for x in arrays if x is not None]),
                    "ivf_int8": gb(*[x for x in arrays8 if x is not None])},
         peak_mem_gb=peak_gb)
    del index, q8, ivf, ivf8, feats, slots, arrays, arrays8
    torch.cuda.empty_cache()


# the RandAugment check (`randaugment_phase`): the flagship's batch
RA_BATCH = 128
RA_RES = 384
RA_N, RA_M = 2, 7
RA_AFFINE = {"ShearX", "ShearY", "TranslateX", "TranslateY", "Rotate"}


def randaugment_phase(card_line: str, seed: int = 0):
    """Device RandAugment (`leccr_torch.data.randaugment`) on the card: a
    bs128 x 384² batch (uint8 / 255 on the host, the same f32 input on
    both sides) through the live policy (n = 2, m = 7) from one generator
    state on the card and on the CPU: each image within 1e-5 of the
    CPU's, within 1/255 where an affine op fired (a resampled point at a
    pixel's edge); ms per batch (host draws included) and each
    op's ms on the whole batch (CUDA events, median of 5).  Then the
    flagship train step with `data.randaugment: true` (2 warm-up, 3 timed
    steps and a profiled one): kernels 2/3 FLAGSHIP_STEP_LAUNCHES a step.
    Returns that step's launches."""
    import torch

    from leccr_torch.config import load_config
    from leccr_torch.data import randaugment as ra

    g = torch.Generator().manual_seed(seed)
    u8 = torch.randint(0, 256, (RA_BATCH, RA_RES, RA_RES, 3),
                       dtype=torch.uint8, generator=g)
    # one input for both: the card divides by a scalar as a product with
    # its reciprocal, an ulp off the host's quotient, and a later
    # Equalize (round(x · 255)) can turn an ulp into a level
    x_cpu = u8.float() / 255.0
    x_gpu = x_cpu.cuda()
    draws = ra.sample_policy(RA_BATCH, RA_N, len(ra.LIVE_POLICY),
                             torch.Generator().manual_seed(seed + 1))
    got = ra.apply_policy(x_gpu, draws, RA_M).cpu()
    want = ra.apply_policy(x_cpu, draws, RA_M)
    fired = (draws.gate <= 0.5)
    names = [[ra.LIVE_POLICY[int(j)] for j in row] for row in draws.op]
    affine = torch.tensor([any(f and n in RA_AFFINE for f, n in zip(fr, nr))
                           for fr, nr in zip(fired.tolist(), names)])
    err = (got - want).abs().amax(dim=(1, 2, 3))
    err_affine = err[affine].max().item() if affine.any() else 0.0
    err_other = err[~affine].max().item() if (~affine).any() else 0.0
    if err_other > 1e-5 or err_affine > 1 / 255:
        raise AssertionError(f"RandAugment on the card differs from the "
                             f"CPU: {err_other} (no affine op), "
                             f"{err_affine} (an affine op)")
    if torch.equal(got, x_cpu):
        raise AssertionError("RandAugment changed no image")
    gen = torch.Generator()
    batch_ms = span_ms(lambda: ra.rand_augment_batch(
        x_gpu, gen, RA_N, RA_M), 5)
    signs = draws.sign[:, 0]
    op_ms = {name: span_ms(lambda fn=fn, name=name: fn(
        x_gpu, RA_M, draws.centre[:, 0] if name == "Cutout" else signs), 5)
        for name, fn in ra.OP_BANK.items()}
    emit("randaugment", card=card_line, batch=RA_BATCH, res=RA_RES,
         n_ops=RA_N, magnitude=RA_M, ops=list(ra.LIVE_POLICY),
         applied=int(fired.sum()), images_with_affine=int(affine.sum()),
         max_abs_err=err_other, max_abs_err_affine=err_affine,
         tolerance="1e-5; 1/255 where an affine op fired",
         ms_per_batch=batch_ms, op_ms=op_ms,
         batch_bytes=x_gpu.numel() * 4)
    del x_gpu, got
    torch.cuda.empty_cache()
    cfg = load_config(str(ROOT / "configs" / "multi30k_all.yaml"))
    cfg.data.randaugment = True
    cfg.data.randaugment_n, cfg.data.randaugment_m = RA_N, RA_M
    return train_step_phase(cfg, card_line, FLAGSHIP_STEP_LAUNCHES,
                            phase="train_step_randaugment", warmup=2,
                            steps=3)


# the ring check (`ring_phase`): configs/scale_vitl_32k.yaml's 32k global
# negatives as 8 ranks' 4096-row blocks at E = 256
RING_WORLD = 8
RING_LOCAL = 4096
RING_DIM = 256
RING_TEMP = 0.07


def _loss_and_grads(fn, a, b, temp):
    import torch

    x = a.clone().requires_grad_(True)
    y = b.clone().requires_grad_(True)
    t = torch.tensor(temp, device=a.device, requires_grad=True)
    loss = fn(x, y, t)
    loss.backward()
    return loss.detach(), x.grad, y.grad, t.grad


def ring_phase(card_line: str, seed: int = 0):
    """The ring InfoNCE replayed in one process (`parallel.ring.
    ring_infonce`, impl="fused") at W = RING_WORLD x b_local = RING_LOCAL,
    E = RING_DIM: forward and backward through kernels 9-11, exactly
    2·W² launches of each (W blocks a rank and direction), held against
    `ops.infonce.infonce_loss` on the same W·b_local rows (one block):
    the loss within 1e-5 of max(1, |x|), d feat_a and d feat_b within 1e-4
    of their largest element, d temp within 1e-4 of max(1, |x|) (kernels
    9-11's tolerances).  Timed (CUDA events, fwd + bwd, median of 3):
    the ring and the one-block loss.  Returns the ring's launches of
    (9, 10, 11)."""
    import torch

    from leccr_torch.ops import infonce
    from leccr_torch.parallel.ring import ring_infonce

    n = RING_WORLD * RING_LOCAL
    g = torch.Generator(device="cuda").manual_seed(seed)
    a, b = (torch.nn.functional.normalize(torch.randn(
        n, RING_DIM, device="cuda", generator=g), dim=-1) for _ in range(2))
    idx = torch.arange(n, device="cuda")

    def ring(x, y, t):
        return ring_infonce(x, y, t, idx, RING_WORLD, "fused")

    def one_block(x, y, t):
        return infonce.infonce_loss(x, y, t, idx)

    reset_counts()
    got = _loss_and_grads(ring, a, b, RING_TEMP)
    torch.cuda.synchronize()
    launches = tuple(getattr(infonce, c) for c in INFONCE_COUNTERS)
    want_launches = (2 * RING_WORLD ** 2,) * 3
    if launches != want_launches:
        raise AssertionError(f"the ring launched kernels 9-11 {launches}, "
                             f"want {want_launches}")
    want = _loss_and_grads(one_block, a, b, RING_TEMP)
    errs = {
        "loss": (got[0] - want[0]).abs().item(),
        "d_feat_a": (got[1] - want[1]).abs().max().item(),
        "d_feat_b": (got[2] - want[2]).abs().max().item(),
        "d_temp": (got[3] - want[3]).abs().item()}
    bounds = {"loss": 1e-5 * max(1.0, want[0].abs().item()),
              "d_feat_a": 1e-4 * want[1].abs().max().item(),
              "d_feat_b": 1e-4 * want[2].abs().max().item(),
              "d_temp": 1e-4 * max(1.0, want[3].abs().item())}
    if any(errs[k] > bounds[k] for k in errs):
        raise AssertionError(f"the ring differs from the one-block loss: "
                             f"{errs}, bounds {bounds}")
    ring_ms = span_ms(lambda: _loss_and_grads(ring, a, b, RING_TEMP), 3)
    block_ms = span_ms(lambda: _loss_and_grads(one_block, a, b, RING_TEMP),
                       3)
    flops = 3 * 2 * 2 * n * n * RING_DIM  # 2 directions x (stats, dq, dk)
    emit("ring", card=card_line, world=RING_WORLD, b_local=RING_LOCAL,
         rows=n, dim=RING_DIM, impl="fused (kernels 9-11), one-process "
         "replay of the ranks' schedules", launches=dict(zip(
             INFONCE_COUNTERS, launches)), errors=errs, bounds=bounds,
         loss=want[0].item(), ring_ms=ring_ms, one_block_ms=block_ms,
         ring_vs_one_block=ring_ms / block_ms,
         bound_ms=flops / PEAK_FLOPS["float32"] * 1e3,
         tflops=flops / ring_ms / 1e9)
    del a, b, got, want
    torch.cuda.empty_cache()
    return launches


# the distributed check (`distributed_phase`): the flagship from synthetic
# files, 2 steps at bs128 (128 images x 2 captions), 16 eval images, a
# checkpoint after each step (step 1's is the one the check reads)
DIST_OPTIONS = {"data.dataset": "synthetic", "data.synthetic_size": 128,
                "data.synthetic_captions_per_image": 2,
                "data.synthetic_eval_images": 16,
                "train.schedular.epochs": 1, "train.keep_checkpoints": 2,
                "train.checkpoint_every_steps": 1,
                "parallel.negatives": "ring_fused"}
# `moment_drift`'s bound on the one-rank ring run's Adam first moments
# after step 1 against the dense run's, over the parameters whose moment's
# rms is at least DIST_SIGNAL_RMS of the rms over all (25 of 461 left out,
# the key biases at 5e-4-1.5e-3 of it).  On the H100 sound runs read
# 3.9e-3, 3.2e-3, 4.3e-3 and 5.2e-3 at train and data seeds 2, 3, 4 and 5;
# planted faults read 1.0 (every gradient doubled after all_reduce_grads),
# 2.47e-2 (kernel 10's dq_raw scaled by 1.001) and 2.45e-2 (kernel 11's
# dk_raw by 1.001) (PERF.md §6)
DIST_SIGNAL_RMS = 1e-2
DIST_MOMENT_BOUND = 1e-2
# the first moment's name in the optimizer state: the port's AdamW's, or
# torch.optim.AdamW's (f32 moments, the flagship's)
MU_NAMES = ("mu", "exp_avg")


def moment_drift(got: dict, want: dict) -> dict:
    """The Adam first moments of two optimizer state_dicts of one model
    after step 1, (1 − β₁)·g of the clipped gradient g: the largest
    ‖got − want‖ / ‖want‖ over the parameters whose moment's rms is at
    least DIST_SIGNAL_RMS of the rms over all parameters (`drift`, at
    index `at`), how many parameters that holds (`held`) and leaves out
    (`noise`), and the same ratio over all parameters together
    (`global`).  The parameters left out carry f32 noise around an exact
    0 (the attention key biases: softmax is shift-invariant), which any
    change of rounding moves by its own size."""
    if got["state"].keys() != want["state"].keys():
        raise AssertionError("the optimizer states hold other parameters")
    rows = []
    for idx, w in want["state"].items():
        key = next(n for n in MU_NAMES if n in w)
        b = w[key].double()
        rows.append((idx, b.numel(), b.norm().item(),
                     (got["state"][idx][key].double() - b).norm().item()))
    norm = math.sqrt(sum(r[2] ** 2 for r in rows))
    rms = norm / math.sqrt(sum(r[1] for r in rows))
    held = [(r[3] / r[2], r[0]) for r in rows
            if r[2] > 0.0 and r[2] / math.sqrt(r[1]) >= DIST_SIGNAL_RMS * rms]
    drift, at = max(held, default=(0.0, None))
    return {"drift": drift, "at": at, "held": len(held),
            "noise": len(rows) - len(held),
            "global": math.sqrt(sum(r[3] ** 2 for r in rows)) / norm}


def distributed_phase(card_line: str):
    """`python -m leccr_torch.run --task itr_caption --multihost` in this
    process under torchrun's environment for a world of one (NCCL, rank
    0, a free port) at the flagship's width (configs/multi30k_all.yaml,
    DIST_OPTIONS: 2 steps at bs128, negatives ring_fused, an eval of val +
    test, a checkpoint after each step), and the same run without
    --multihost.  With the process group the ITC losses take the ring
    (`ring_infonce_local` at W = 1: kernels 9-11, 6 launches each a step);
    without it, ring_fused on one block is the dense loss.  Checks:
    kernels 2/3 FLAGSHIP_STEP_LAUNCHES a step in both, 9-11 as said,
    kernel 1 7 an eval batch; the Adam first moments in the step-1
    checkpoints (both runs from the same parameters: the forward, the
    ring's backward through kernels 10/11, all_reduce_grads, the
    temperature's cotangent and the clip, all that differs between the
    runs, end in them) within DIST_MOMENT_BOUND of the dense run's
    (`moment_drift`); rank 0's checkpoint and
    best.json; `--devices 2` on this one-GPU host raises.  The logged
    losses (the epoch's mean over both steps) are reported, not held: the
    first update turns the two ITC paths' f32 sum-order differences into
    bf16 rounding flips of some weights, so step 2's losses differ by a
    chaotic 0.5-5.5e-4 that any change of the kernels' roundings re-draws
    (PERF.md §6).  W > 1 runs only in the CPU tests (gloo): NCCL refuses
    two ranks on one GPU.  Returns the multihost run's launches of
    (2..11) and kernel 1's counts."""
    import os
    import shutil
    import tempfile

    import torch

    from leccr_torch import run
    from leccr_torch.config import load_config
    from leccr_torch.train.checkpoints import CheckpointManager

    root = Path(tempfile.mkdtemp(prefix="chip_smoke_dist_"))
    env_keys = ("RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_ADDR",
                "MASTER_PORT")
    try:
        cfg = load_config(str(ROOT / "configs" / "multi30k_all.yaml"))
        set_options(cfg, DIST_OPTIONS)
        cfg.save(str(root / "config.json"))
        results = {}
        for mode in ("multihost", "single"):
            out = root / mode
            argv = ["--task", "itr_caption", "--config",
                    str(root / "config.json"), "--output_dir", str(out)]
            if mode == "multihost":
                os.environ.update(RANK="0", LOCAL_RANK="0", WORLD_SIZE="1",
                                  MASTER_ADDR="localhost",
                                  MASTER_PORT=str(run._free_port()))
                argv.append("--multihost")
            reset_counts()
            t0 = time.perf_counter()
            try:
                run.main(argv)
            finally:
                for key in env_keys:
                    os.environ.pop(key, None)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = step_counts()
            kernel1 = kernel1_counts(f"distributed_phase ({mode})")
            records = [json.loads(x) for x in
                       (out / "log.txt").read_text().splitlines()]
            if not (out / "checkpoints" / "best.json").exists():
                raise AssertionError(f"{mode}: no checkpoint was written")
            _, opt, _, meta = CheckpointManager.read(
                out / "checkpoints" / "step_00000001.pt")
            if meta["step"] != 1:
                raise AssertionError(f"{mode}: the step-1 checkpoint holds "
                                     f"step {meta['step']}")
            results[mode] = (launches, kernel1, records[0], wall, opt)
        steps = 2
        ring = (6 * steps,) * 3
        for mode, (launches, *_) in results.items():
            want = tuple(x * steps for x in FLAGSHIP_STEP_LAUNCHES[:7]) + (
                ring if mode == "multihost" else (0, 0, 0))
            if launches != want:
                raise AssertionError(f"distributed_phase ({mode}) launched "
                                     f"kernels {launches}, want {want}")
        drift = moment_drift(results["multihost"][4], results["single"][4])
        if not drift["drift"] <= DIST_MOMENT_BOUND:
            raise AssertionError(f"the one-rank run's Adam first moments "
                                 f"after step 1 differ: {drift}, bound "
                                 f"{DIST_MOMENT_BOUND}")
        got, want = results["multihost"][2], results["single"][2]
        loss_err = {k: abs(float(got[k]) - float(v)) for k, v in want.items()
                    if k.startswith("train_loss")}
        try:
            run.main(["--task", "itr_caption", "--config",
                      str(root / "config.json"), "--output_dir",
                      str(root / "two"), "--devices", "2"])
        except ValueError as exc:
            refused = str(exc)
        else:
            raise AssertionError("--devices 2 ran on a one-GPU host")
        emit("distributed", card=card_line, world=1, backend="nccl",
             negatives="ring_fused", steps=steps,
             launches={mode: dict(zip(STEP_COUNTERS, r[0]))
                       for mode, r in results.items()},
             kernel1={mode: r[1] for mode, r in results.items()},
             train_losses={mode: {k: v for k, v in r[2].items()
                                  if k.startswith("train_loss")}
                           for mode, r in results.items()},
             mu_drift=drift, mu_bound=DIST_MOMENT_BOUND,
             loss_err=loss_err, wall_s={m: r[3] for m, r in results.items()},
             devices_2_refused=refused,
             note="W > 1 is checked only in the CPU tests (gloo): NCCL "
                  "refuses two ranks on one GPU")
        return results["multihost"][0], results["multihost"][1]
    finally:
        shutil.rmtree(root, ignore_errors=True)


SHARDS = 4


def sharded_serve_phase(card_line, index, q8, q, valid, k: int = 10):
    """The 1M-row index of `index_scale_phase` row-sharded SHARDS ways on
    cuda:0 (`serve.shard_index`): the sharded top-k (`_sharded_top_k`)
    equals the unsharded search bit for bit, scores and rows, for f32 and
    int8, fusion none and minmax; ms per batch of INDEX_QUERIES (median of
    5) beside the unsharded search's."""
    import torch

    from leccr_torch.serve import (_search_scores, _sharded_top_k, _top_k,
                                   shard_index)

    times = {}
    for name, idx in (("f32", index), ("int8", q8)):
        t0 = time.perf_counter()
        sharded = shard_index(idx, ["cuda:0"] * SHARDS)
        torch.cuda.synchronize()
        times[f"{name}_shard_s"] = time.perf_counter() - t0
        for fusion in ("none", "minmax"):
            want = _top_k(_search_scores(q, idx, valid, fusion, 0.9), k)
            got = _sharded_top_k(q, sharded, valid, fusion, 0.9, k)
            if not (torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1])):
                raise AssertionError(f"the sharded search ({name}, "
                                     f"{fusion}) differs from the "
                                     f"unsharded one")
            times[f"{name}_{fusion}_ms"] = span_ms(
                lambda s=sharded, f=fusion: _sharded_top_k(
                    q, s, valid, f, 0.9, k), 5)
        del sharded
        torch.cuda.empty_cache()
    emit("sharded_serve", card=card_line, rows=index.n_valid,
         shards=SHARDS, devices="cuda:0 x 4", queries=q.shape[0], k=k,
         equal_to_unsharded="bit for bit (f32, int8; none, minmax)",
         **times)


# (name, regime, B, H, L, key padding, model counts, blocks) of the tensor-
# parallel phase: the flagship's ViT-B/32 @384 and mBERT-base at 128 tokens
# (kernels 2/3; at M = 4, 3 heads a rank), ViT-L/14 @336 (kernels 4/5) and
# ViT-L/14 @728 (kernels 6-8, head_group(16) = 8 across two ranks of 4)
TP_CASES = [("flagship-vision", "single", 128, 12, 145, False, (2, 4),
             ("vit-b",)),
            ("flagship-text", "single", 128, 12, 128, True, (2, 4),
             ("mbert",)),
            ("long-sequence", "chunked", 32, 16, 577, False, (4,),
             ("vit-l",)),
            ("high-resolution", "tiled", HIRES_BATCH, 16, HIRES_TOKENS,
             False, (4,), ("vit-l",))]
TP_RATE = 0.1
TP_MASK_BATCH = 2  # the mask read-backs' batch
TP_ITERS = 10
# kernels (2, 3, 4, 5, 6, 7, 8) a replayed block launches at M ranks, a
# forward and a backward: one call of the regime's kernels a rank
TP_BLOCK_LAUNCHES = {"single": (1, 1, 0, 0, 0, 0, 0),
                     "chunked": (0, 0, 1, 1, 0, 0, 0),
                     "tiled": (0, 0, 0, 0, 1, 1, 1)}


class _SoloGroup:
    """One model rank's collectives as local stand-ins, to time a rank's
    block alone: the reduce keeps the rank's partial (in f32), the gather
    repeats the rank's slice."""

    def __init__(self, rank, world):
        self.rank, self.world = rank, world

    def copy(self, x):
        return x

    def reduce(self, x):
        return x.float()

    def gather(self, x):
        import torch

        return torch.cat([x] * self.world, dim=-1)


def tp_block(kind, length):
    """A dense transformer block of `kind` on the card (f32 masters, bf16
    compute, seeded random weights) and its call(block, x, gen)."""
    import torch

    from leccr_torch.config import load_config
    from leccr_torch.models.bert import _BertLayer
    from leccr_torch.models.clip import CLIP_VARIANTS, _ResidualBlock
    from leccr_torch.ops.attention import set_compute_dtype

    if kind == "mbert":
        text = load_config(str(ROOT / "configs" / "multi30k_all.yaml")
                           ).model.text
        text.hidden_dropout = text.attention_dropout = TP_RATE
        block = _BertLayer(text)
        mask = torch.ones(1, length, dtype=torch.int32, device="cuda")

        def call(blk, x, gen):
            m = mask.expand(x.shape[0], -1).clone()
            m[1, length // 3:] = 0
            return blk(x, m, False, gen)
    else:
        var = CLIP_VARIANTS["ViT-B/32" if kind == "vit-b" else "ViT-L/14"]
        block = _ResidualBlock(var.vision_width, var.vision_heads,
                               fused=True)

        def call(blk, x, gen):
            return blk(x, False)  # the flash path; the CLIP tower has no
            # dropout
    block = block.cuda()
    g = torch.Generator(device="cuda").manual_seed(7)
    with torch.no_grad():  # lecun-normal kernels, LayerNorms near 1
        for name, p in block.named_parameters():
            r = torch.randn(p.shape, device="cuda", generator=g)
            if p.dim() == 2:
                p.copy_(r * p.shape[1] ** -0.5)
            elif "ln" in name and name.endswith("weight"):
                p.copy_(1.0 + 0.1 * r)
            else:
                p.copy_(0.02 * r)
    set_compute_dtype(block, torch.bfloat16)
    return block, call


def tp_kernel_check(name, regime, b, heads, length, padded, world, seed):
    """Each rank's heads through the kernels at its offset and the layer's
    H, forward and backward at rate TP_RATE, against the dense call's
    heads; then the masks the kernels apply on rank 1's heads, read back,
    against the plain hash at the offset."""
    import torch

    from leccr_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, grad = (path_layout(torch.randn(
        (b, length, heads, 64), device="cuda", generator=g,
        dtype=torch.bfloat16)) for _ in range(4))
    pad = None
    if padded:
        pad = torch.zeros(b, length, dtype=torch.bool, device="cuda")
        pad[1, length // 3:] = True
    assert fa.regime(q, k) == regime
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = fa.flash_tower_attention(*leaves, pad, seed, TP_RATE)
    out.backward(grad)
    dense = [out.detach()] + [t.grad for t in leaves]
    local = heads // world
    worst, bit_equal = 0.0, True
    for m in range(world):
        h0 = m * local
        part = [t.detach()[:, h0:h0 + local].requires_grad_()
                for t in (q, k, v)]
        assert fa.regime(part[0], part[1], num_heads=heads) == regime
        out = fa.flash_tower_attention(*part, pad, seed, TP_RATE, h0, heads)
        out.backward(grad[:, h0:h0 + local])
        for got, want in zip([out.detach()] + [t.grad for t in part],
                             dense):
            want = want[:, h0:h0 + local]
            bit_equal &= bool(torch.equal(got, want))
            err = (got.float() - want.float()).abs()
            tol = 1e-5 + BF16_K * bf16_ulp(want)
            if not bool((err <= tol).all()):
                raise AssertionError(f"{name} at M={world}, rank {m}: a "
                                     f"local-head result off the dense")
            worst = max(worst, err.max().item())
    # the masks of rank 1's heads [h0, h0 + local), read back
    h0, mb = local, TP_MASK_BATCH
    if regime == "single":
        masks = single_masks(mb, local, length, torch.bfloat16, TP_RATE,
                             seed, span=(h0, heads))
        want = fa.keep_mask(seed, mb, local, length, length, TP_RATE,
                            device="cuda", h0=h0) != 0
    else:
        hg = (fa.chunk_head_group(heads) if regime == "chunked"
              else fa.head_group(heads))
        if regime == "chunked":
            masks = [fwd_masks(fa.flash_chunked_attention_fwd, mb, local,
                               length, torch.bfloat16, TP_RATE, seed,
                               span=(h0, heads))]
            masks += chunk_bwd_masks(mb, local, length, torch.bfloat16,
                                     TP_RATE, seed, span=(h0, heads))
        else:
            masks = tiled_masks(mb, local, length, torch.bfloat16, TP_RATE,
                                seed, span=(h0, heads))
        want = fa.tile_keep_mask(seed, mb, local, length, length, TP_RATE,
                                 device="cuda", hg=hg, h0=h0) != 0
    if not all(torch.equal(mk, want) for mk in masks):
        raise AssertionError(f"{name} at M={world}: the kernels' masks on "
                             f"heads [{h0}, {h0 + local}) are not the plain "
                             f"hash at the offset")
    return {"max_abs_err": worst, "bit_equal": bit_equal,
            "masks_read_back": len(masks), "mask_heads": [h0, h0 + local]}


def tp_block_check(kind, b, length, world, seed):
    """The ranks' block, replayed (`replay_model_ranks`), against the dense
    block, both in bf16, forward and backward at dropout TP_RATE (mBERT:
    its hidden and attention dropout; a CLIP block has none), and the
    dense block in f32 as the reference: per tensor (the output, dx and
    every parameter's gradient) max |ranks - dense| <= 2 max |dense - f32|
    + M ulp_bf16(max |f32|), one bf16 rounding per partial sum on top of
    twice the bf16 block's own error.  Then the launches of kernels 2-8 in
    the replay, and rank 0's block alone (its collectives local stand-ins,
    `_SoloGroup`) beside the dense block, forward + backward: device ms
    (the profiler's kernel time a call, over TP_ITERS calls) and event ms
    after a 1 GiB L2 flush (which a small block's host dispatch can
    exceed: device ms is the layer's time)."""
    import copy

    import torch

    from leccr_torch.ops.attention import set_compute_dtype
    from leccr_torch.ops.dropout import Generators
    from leccr_torch.parallel.tensor import (
        merge_replay,
        replay_model_ranks,
        shard_model,
    )

    block, call = tp_block(kind, length)
    width = (block.attention.query.in_features if kind == "mbert"
             else block.c_fc.in_features)
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((b, length, width), device="cuda", generator=g)
    gy = torch.randn((b, length, width), device="cuda", generator=g)

    def gens():
        return Generators.from_seed(seed, "cuda")

    def run(blk, dtype):
        xi = x.detach().to(dtype).requires_grad_()
        blk.zero_grad(set_to_none=True)
        y = call(blk, xi, gens())
        y.backward(gy.to(y.dtype))
        return {"y": y.detach().float(), "dx": xi.grad.float(),
                **{n: p.grad.float() for n, p in blk.named_parameters()}}

    dense = run(block, torch.bfloat16)
    ref_block = copy.deepcopy(block)
    set_compute_dtype(ref_block, torch.float32)
    ref = run(ref_block, torch.float32)
    del ref_block
    reset_counts()
    xi = x.detach().to(torch.bfloat16).requires_grad_()
    outs, shards = replay_model_ranks(
        block, world, (xi,), call=lambda s, r, xx: call(s, xx, gens()))
    outs[0].backward(gy.to(outs[0].dtype))
    launches = step_counts()[:len(COUNTERS)]
    got = {"y": outs[0].detach().float(), "dx": xi.grad.float(),
           **{n: t.float() for n, t in
              merge_replay(shards, grads=True).items()}}
    ratio, worst = 0.0, {}
    for key, want in dense.items():
        err = (got[key] - want).abs().max().item()
        noise = (want - ref[key]).abs().max().item()
        bound = 2 * noise + world * bf16_ulp(
            ref[key].abs().max()).item()
        if err > bound:
            raise AssertionError(f"{kind} block at M={world}: {key} off the "
                                 f"dense block by {err} > {bound}")
        ratio = max(ratio, err / bound)
        if key in ("y", "dx"):
            worst[key] = {"err": err, "dense_vs_f32": noise,
                          "bound": bound}
    del shards, outs
    solo = shard_model(copy.deepcopy(block), _SoloGroup(0, world))
    flush_buf = torch.empty(2 ** 30, dtype=torch.uint8, device="cuda")

    def fwd_bwd(blk):
        def fn():
            xi = x.detach().to(torch.bfloat16).requires_grad_()
            y = call(blk, xi, gens())
            y.backward(gy.to(y.dtype))
        return fn

    times = {}
    for who, blk in (("dense", block), ("rank", solo)):
        times[f"{who}_block_ms"] = cuda_ms(fwd_bwd(blk), flush_buf.zero_,
                                           TP_ITERS)
        times[f"{who}_block_device_ms"], times[f"{who}_top"] = (
            device_ms_per_call(fwd_bwd(blk), TP_ITERS))
    del flush_buf
    return {"kind": kind, "b": b, "l": length, "width": width,
            "world": world, "launches": list(launches),
            "y_dx": worst, "worst_err_over_bound": ratio, **times,
            "rank_over_dense_device": (times["rank_block_device_ms"]
                                       / times["dense_block_device_ms"])}


def device_ms_per_call(fn, iters: int, top: int = 6, warm: bool = True,
                       host: bool = True):
    """(the device's kernel time a call of fn(), from torch.profiler over
    `iters` calls after a warm-up (`warm`; host time not counted); the
    `top` kernels by time, ms a call).  host=False traces the device
    alone (less to record for a call of many launches)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if warm:
        fn()
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA]
    if host:
        activities.insert(0, ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if str(getattr(e, "device_type", "")).endswith("CUDA")
              and not getattr(e, "is_user_annotation", False)]
    total = sum(e.self_device_time_total for e in events)
    if total <= 0:
        raise AssertionError("the profiler saw no device time")
    rows = sorted(events, key=lambda e: -e.self_device_time_total)[:top]
    return total / 1e3 / iters, [
        {"name": e.key[:60], "ms": e.self_device_time_total / 1e3 / iters}
        for e in rows]


def tensor_parallel_phase(card_line: str, seed: int = 4321):
    """Phase 20 (see the docstring): each case's kernels on each rank's
    heads, the masks at the offset, and the replayed block.  Returns the
    launches of kernels 2-8 (COUNTERS order) in the block replays."""
    t0 = time.perf_counter()
    total = [0] * len(COUNTERS)
    for name, regime, b, heads, length, padded, worlds, blocks in TP_CASES:
        for world in worlds:
            kernels = tp_kernel_check(name, regime, b, heads, length, padded,
                                      world, seed)
            rows = []
            for kind in blocks:
                row = tp_block_check(kind, b, length, world, seed)
                want = [world * n for n in TP_BLOCK_LAUNCHES[regime]]
                if row["launches"] != want:
                    raise AssertionError(
                        f"{name} {kind} block at M={world} launched kernels "
                        f"2-8 {row['launches']}, not {want}")
                total = [a + n for a, n in zip(total, row["launches"])]
                rows.append(row)
            emit("tensor_parallel", case=name, regime=regime,
                 shape=[b, heads, length, 64], world=world,
                 heads_per_rank=heads // world, rate=TP_RATE,
                 kernels=kernels, blocks=rows, card=card_line)
    emit("tensor_parallel_done", launches=total,
         wall_s=time.perf_counter() - t0)
    return total


FSDP_BLOCKS = 4  # the one-process data ranks of phase 21
FSDP_SCALE_BATCH = 32
FSDP_SCALE_OPTIONS = {"parallel.model": 1, "parallel.fsdp": True,
                      "train.grad_cache_microbatches": 2,
                      "parallel.stream_loss_block_rows": 8,
                      "train.batch_size_train": FSDP_SCALE_BATCH}


def fsdp_run(cfg, batch: int, steps: int, fsdp: bool, seed: int = 0,
             iters: int = 1):
    """`steps` train steps of `TrainStep(num_blocks=FSDP_BLOCKS)` on one
    batch (bf16 compute on f32 masters), with `parallel.fsdp` = fsdp, then
    the step's device time over `iters` more steps under the profiler.  Returns a dict: the losses, the dense parameters and Adam
    moments (by parameter name) after the checked steps, kernels 2-11's
    launches in them, the parameters that did not move, the run's peak
    memory in those steps (past what was allocated before it), device ms,
    and for FSDP a rank's bytes of parameters plus moments."""
    import copy

    import torch

    from leccr_torch.models.leccr import LECCRModel
    from leccr_torch.parallel.tensor import (
        _param_names,
        gather_optimizer_state,
        gather_state,
    )
    from leccr_torch.train.step import make_train_step

    cfg = copy.deepcopy(cfg)
    cfg.parallel.fsdp = fsdp
    cfg.train.schedular.num_warmup_steps = 0
    cfg.train.optimizer.lr = 1e-5
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # e.g. an earlier run's results
    t0 = time.perf_counter()
    model = LECCRModel(cfg.model, device="cuda", seed=seed)
    step = make_train_step(cfg, model, total_steps=10000,
                           num_blocks=FSDP_BLOCKS)
    data = train_batch(cfg, batch, 64, seed + 5)
    start = [p.detach().clone() for p in step.params]
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    reset_counts()
    losses = [step(data, i) for i in range(steps)]
    torch.cuda.synchronize()
    steps_s = time.perf_counter() - t0 - build_s
    peak_gb = (torch.cuda.max_memory_allocated() - held) / 1e9
    launches, tc = step_counts(), tc_counts()
    named = {id(p): n for n, p in model.named_parameters()}
    unmoved = sorted(named[id(p)] for p, s in zip(step.params, start)
                     if torch.equal(p.detach(), s))
    del start
    names = _param_names(model, step.optimizer)
    out = {"losses": losses, "launches": launches, "tc": tc,
           "unmoved": unmoved,
           "params": {k: v.clone() for k, v in gather_state(model).items()},
           "moments": {names[i]: {k: v.clone() for k, v in entry.items()
                                  if k != "step"}
                       for i, entry in gather_optimizer_state(
                           model, step.optimizer)["state"].items()},
           "peak_mem_gb": peak_gb}
    state = getattr(model, "fsdp", None)
    if state is not None:
        names = {id(p): n for n, p in model.named_parameters()}
        rank = dense = 0
        for p in step.params:
            held = [p] + [v for k, v in step.optimizer.state[p].items()
                          if k != "step" and torch.is_tensor(v)]
            nbytes = sum(t.numel() * t.element_size() for t in held)
            dense += nbytes
            rank += (nbytes // FSDP_BLOCKS if names[id(p)] in state.dims
                     else nbytes)
        out.update(rank_state_bytes=rank, dense_state_bytes=dense,
                   rank_share=rank / dense, sharded_params=len(state.dims),
                   replicated_params=len(step.params) - len(state.dims))
    t0 = time.perf_counter()
    out["device_ms"], out["top"] = device_ms_per_call(
        lambda: step(data, steps), iters, warm=False, host=False)
    out["wall_s"] = {"build": build_s, "steps": steps_s,
                     "profiled": time.perf_counter() - t0}
    del model, step, data
    torch.cuda.empty_cache()
    return out


def fsdp_diff(got: dict, want: dict) -> dict:
    """{tensor: max |got - want|} over the parameters ("name") and Adam
    moments ("name#key") that are not bit for bit equal, and "losses" when
    those differ."""
    import torch

    out = {}
    pairs = [(n, got["params"][n], v) for n, v in want["params"].items()]
    pairs += [(f"{n}#{k}", got["moments"][n][k], v)
              for n, entry in want["moments"].items()
              for k, v in entry.items()]
    for name, a, b in pairs:
        if not torch.equal(a, b):
            out[name] = (a.float() - b.float()).abs().max().item()
    if got["losses"] != want["losses"]:
        out["losses"] = max(abs(got["losses"][i][k] - v)
                            for i, row in enumerate(want["losses"])
                            for k, v in row.items())
    return out


def fsdp_check(what: str, dense: dict, fsdp: dict) -> None:
    """FSDP's step against the step without it: losses, parameters and
    Adam moments bit for bit."""
    diff = fsdp_diff(fsdp, dense)
    if diff:
        raise AssertionError(f"{what}: FSDP differs from the step without "
                             f"it in {len(diff)} tensors: {diff}")


def fsdp_phase(card_line: str):
    """Phase 21 (see the docstring), under deterministic algorithms: the
    CUDA embedding backward sums a heavily repeated index (the token-type
    table's) in an order that varies run to run otherwise, so the step
    without FSDP would not reproduce itself.  Returns the launches of
    kernels 2-11 (STEP_COUNTERS order): (a)'s of kernels 2/3, (b)'s of
    kernels 9-11."""
    import torch

    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        return _fsdp_phase(card_line)
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])


def _fsdp_phase(card_line: str):
    from leccr_torch.config import load_config

    t0 = time.perf_counter()
    # (a) the flagship, uncut
    cfg = load_config(str(ROOT / "configs" / "multi30k_all.yaml"))
    dense = fsdp_run(cfg, 128, 2, False)
    fsdp = fsdp_run(cfg, 128, 2, True)
    fsdp_check("the flagship", dense, fsdp)
    want = tuple(2 * n for n in FLAGSHIP_STEP_LAUNCHES)
    if fsdp["launches"] != want or dense["launches"] != want or (
            fsdp["tc"] != want[:2]):
        raise AssertionError(f"the flagship launched kernels 2-11 "
                             f"{fsdp['launches']} (wgmma {fsdp['tc']})"
                             f" under FSDP, {dense['launches']} without, "
                             f"want {want}")
    flagship = {k: fsdp[k] for k in (
        "rank_state_bytes", "dense_state_bytes", "rank_share",
        "sharded_params", "replicated_params", "device_ms", "peak_mem_gb",
        "top", "wall_s")}
    flagship.update(dense_device_ms=dense["device_ms"],
                    dense_peak_mem_gb=dense["peak_mem_gb"],
                    fsdp_over_dense_device=(fsdp["device_ms"]
                                            / dense["device_ms"]),
                    launches=dict(zip(STEP_COUNTERS, fsdp["launches"])),
                    losses_last=fsdp["losses"][-1])
    emit("fsdp_flagship", card=card_line, config="configs/multi30k_all.yaml",
         batch=128, num_blocks=FSDP_BLOCKS, steps=2,
         fsdp_min_size=cfg.parallel.fsdp_min_size, bit_for_bit=True,
         deterministic_algorithms=True, **flagship)
    launches = fsdp["launches"][:2]
    del dense, fsdp
    flagship_s = time.perf_counter() - t0

    # (b) the scale composition without the model axis
    cfg = load_config(str(ROOT / "configs" / "scale_vitl_32k.yaml"))
    set_options(cfg, FSDP_SCALE_OPTIONS)
    # 2 steps: at the first, the first caption cross-attention's key bias
    # has an exactly zero gradient (the query slots start at zero) and no
    # weight decay
    dense = fsdp_run(cfg, FSDP_SCALE_BATCH, 2, False)
    fsdp = fsdp_run(cfg, FSDP_SCALE_BATCH, 2, True)
    infonce = slice(len(COUNTERS), len(STEP_COUNTERS))
    finite = all(math.isfinite(v) for row in fsdp["losses"]
                 for v in row.values())
    if not finite or fsdp["unmoved"]:
        raise AssertionError(f"the scale step: finite losses {finite}, "
                             f"unmoved under FSDP {fsdp['unmoved']}, "
                             f"without {dense['unmoved']}")
    fsdp_check("the scale step", dense, fsdp)
    if (fsdp["launches"] != dense["launches"]
            or not all(fsdp["launches"][infonce])
            or any(fsdp["launches"][:len(COUNTERS)])):
        raise AssertionError(f"the scale step launched kernels 2-11 "
                             f"{fsdp['launches']} under FSDP, "
                             f"{dense['launches']} without")
    emit("fsdp_scale", card=card_line, config="configs/scale_vitl_32k.yaml",
         cuts={"batch": FSDP_SCALE_BATCH, "parallel.model": 1,
               "parallel.stream_loss_block_rows": 8},
         num_blocks=FSDP_BLOCKS, steps=2, bit_for_bit=True,
         deterministic_algorithms=True,
         losses=fsdp["losses"], device_ms=fsdp["device_ms"],
         dense_device_ms=dense["device_ms"],
         peak_mem_gb=fsdp["peak_mem_gb"],
         dense_peak_mem_gb=dense["peak_mem_gb"],
         rank_share=fsdp["rank_share"],
         sharded_params=fsdp["sharded_params"],
         replicated_params=fsdp["replicated_params"],
         launches=dict(zip(STEP_COUNTERS, fsdp["launches"])), top=fsdp["top"],
         wall_s=fsdp["wall_s"], dense_wall_s=dense["wall_s"])
    total = launches + (0,) * (len(COUNTERS) - 2) + fsdp["launches"][infonce]
    emit("fsdp_done", launches=dict(zip(STEP_COUNTERS, total)),
         flagship_s=flagship_s, wall_s=time.perf_counter() - t0)
    return total


def main() -> int:
    import shutil
    import tempfile

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
    # and every instantiation of kernels 2/3's Hopper kernels (12 forwards
    # by 16-key steps, 3 backwards by 64-key boxes)
    single_ptxas = {}
    if _build.build_info["flash_tower_attention"][1]:
        single_ptxas = ptxas_instances(
            _build.build_info["flash_tower_attention"][1],
            SINGLE_WGMMA_KERNELS)
        if len(single_ptxas) != 15 or not all(
                r.get("spill_stores") == r.get("spill_loads") == 0
                for r in single_ptxas.values()):
            raise AssertionError(f"kernels 2/3 spill or are missing from "
                                 f"ptxas' report: {single_ptxas}")
    # and every instantiation of kernel 1's wide-head kernels (4 key
    # ranges, 2 merges, 2 query rows): no spill and no stack frame
    wide_ptxas = {}
    if _build.build_info["fused_cross_attention"][1]:
        wide_ptxas = fca_wide_instances(
            _build.build_info["fused_cross_attention"][1])
        if len(wide_ptxas) != FCA_WIDE_INSTANCES or not all(
                r.get("spill_stores") == r.get("spill_loads")
                == r.get("stack_frame") == 0 for r in wide_ptxas.values()):
            raise AssertionError(f"kernel 1's wide bodies spill, use a stack "
                                 f"frame or are missing from ptxas' report: "
                                 f"{wide_ptxas}")
    emit("build", kernels=list(KERNEL_LIBS),
         wall_s=time.perf_counter() - t0,
         nvcc_s={n: _build.build_info[n][0] for n in KERNEL_LIBS},
         ptxas={n: sorted({ln.split(":", 1)[1].strip() for ln in
                           _build.build_info[n][1].splitlines()
                           if "ptxas info    : Used" in ln})
                for n in KERNEL_LIBS},
         wgmma_ptxas=wgmma_ptxas, infonce_ptxas=infonce_ptxas,
         single_ptxas=single_ptxas, fca_wide_ptxas=wide_ptxas)

    shapes = kernel_phase()
    flash = flash_phase()
    chunked = chunked_phase()
    tiled = tiled_phase()
    infonce = infonce_phase()
    ring_launches = ring_phase(card_line)
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
    ra_launches = randaugment_phase(card_line)
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
    fit_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_fit_"))
    try:
        fit_launches, fit_kernel1, fit_ckpt = fit_phase(card_line, fit_dir)
        ckpt_launches, ckpt_kernel1 = checkpoint_phase(card_line)
        video_shapes, video_launches, video_kernel1 = video_phase(card_line)
        serve_tasks_kernel1 = serve_tasks_phase(card_line, fit_ckpt)
    finally:
        shutil.rmtree(fit_dir, ignore_errors=True)
    dist_launches, dist_kernel1 = distributed_phase(card_line)
    index_scale_phase(card_line)
    tp_launches = tensor_parallel_phase(card_line)
    fsdp_launches = fsdp_phase(card_line)

    def path_sum(key, rows=None, launches=PATH_LAUNCHES):
        # bf16 at B=64: one embed_images batch, 7 launches
        return sum(launches[(r["lq"], r["lk"])] * r[key]
                   for r in (bf16 if rows is None else rows))

    bf16 = [r for r in shapes if r["dtype"] == "bfloat16"]
    video_bf16 = [r for r in video_shapes if r["dtype"] == "bfloat16"]
    vision_layers = (cfg.model.vision.depth
                     or CLIP_VARIANTS[cfg.model.vision.variant].vision_layers)
    text_layers = cfg.model.text.num_layers
    per_step = {"vision": vision_layers, "text": text_layers,
                "caption": text_layers}

    def flash_entry(name, line, direction, launches, slice_launches,
                    hires_launches, large_launches, fit_launches,
                    ckpt_launches, video_launches, ra_launches, dist_launches,
                    errs):
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
            "launches_checkpoint": ckpt_launches,
            "launches_video": video_launches,
            "launches_randaugment_step": ra_launches,
            "launches_distributed": dist_launches,
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
        at = INFONCE_COUNTERS.index(f"{kernel}_launches")
        per_step = LARGE_STEP_LAUNCHES[STEP_COUNTERS.index(
            f"{kernel}_launches")]
        return {
            "name": name, "route": "cuda",
            "source": "leccr_torch/csrc/fused_infonce.cu",
            "replaces": f"leccr_tpu/ops/infonce.py:{line}",
            "launches": launches,
            "launches_ring": ring_launches[at],
            "launches_distributed": dist_launches[len(COUNTERS) + at],
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

    entries = [{
        "name": "fused_cross_attention",
        "route": "cuda",
        "source": "leccr_torch/csrc/fused_cross_attention.cu",
        "replaces": "leccr_tpu/ops/pallas_attention.py:26",
        "launches": serve_launches["all"] + eval_launches["all"],
        "launches_serve": serve_launches,
        "launches_eval": eval_launches,
        "launches_fit": fit_kernel1,
        "launches_checkpoint": ckpt_kernel1,
        "launches_video": video_kernel1,
        "launches_serve_tasks": serve_tasks_kernel1,
        "launches_distributed": dist_kernel1,
        "bodies": sorted({r["body"] for r in bf16 + video_bf16}),
        "max_abs_err": max(r["max_abs_err"] for r in shapes + video_shapes),
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
        "video": {
            "timed_as": "bf16, B=64, Dh=512 (configs/msrvtt.yaml): "
                        "3x(2,200) + 2x(32,2) + 2x(2,32), the 7 launches "
                        "of one video embed_images batch, wide key ranges "
                        "at (2,200) and (2,32), wide query rows at (32,2), "
                        "L2 flushed",
            **{key: path_sum(key, video_bf16, VIDEO_PATH_LAUNCHES)
               for key in ("ms", "plain_ms", "bound_ms", "library_ms")},
            "bound_by": ("bytes" if all(r["bound_by"] == "bytes"
                                        for r in video_bf16)
                         else "operations"),
            "shapes": video_shapes,
        },
    }, flash_entry("flash_tower_attention_fwd", 84, "fwd", train_launches[0],
                   slice_launches[0], hires_launches[0], large_launches[0],
                   fit_launches[0], ckpt_launches[0], video_launches[0],
                   ra_launches[0], dist_launches[0], ("out", "lse")),
        flash_entry("flash_tower_attention_bwd", 110, "bwd",
                    train_launches[1], slice_launches[1], hires_launches[1],
                    large_launches[1], fit_launches[1], ckpt_launches[1],
                    video_launches[1], ra_launches[1], dist_launches[1],
                    ("dq", "dk", "dv")),
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
    ]
    # kernels 2-8 (entries 1-7): their launches in phase 20's replayed
    # blocks
    for entry, n in zip(entries[1:1 + len(COUNTERS)], tp_launches):
        entry["launches_tensor_parallel"] = n
    # kernels 2/3 and 9-11: their launches in phase 21's FSDP steps
    for at in (0, 1, 7, 8, 9):
        entries[1 + at]["launches_fsdp"] = fsdp_launches[at]
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
