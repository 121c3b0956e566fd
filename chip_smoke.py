#!/usr/bin/env python3
"""Drive the PyTorch port (`leccr_torch`) on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, each printing one JSON line (any failure raises: exit code 1):

1. device + build: the card's name and power limit (nvidia-smi), then the
   CUDA kernels built from `leccr_torch/csrc/` with nvcc (seconds, ptxas
   report).
2. kernel vs plain: the fused cross-attention kernel against its plain
   PyTorch version at the three embed_images shapes (B=64, H=8, Dh=64;
   (Lq, Lk) = (4,200), (145,4), (4,145)) in bf16 and f32, with random key
   padding and one fully padded row.  Tolerance: f32 max abs err <= 1e-5;
   bf16 every element within 1e-5 plus 1 bf16 ulp of the plain result (both
   round an f32 result to bf16 once, so f32 noise can move it one ulp).  Times the kernel, the
   plain version and F.scaled_dot_product_attention (a yardstick only; the
   port never calls it) with the L2 cache flushed before each launch, and
   computes the least time the card could take (bytes at 3.35 TB/s vs
   flops at the dtype's peak).
3. model check: the full-width model in f32 with the kernel vs with the
   plain attention path, on 4 images (atol 1e-4).
4. serving: `Embedder` at the flagship widths of configs/multi30k_all.yaml
   (ViT-B/32 @384², mBERT-base, 3/2/2 caption-interaction layers, bf16)
   with seeded random weights indexes 256 synthetic images with captions at
   200 tokens and answers search_texts (none, minmax) and search_images
   requests; the kernel's launch count must be 7 per image batch.
5. eval: Multi30K scale (1 000 images × 5 000 texts at 200 tokens, image
   batch 50, text batch 256): embed + streaming ranks + Recall@K; the ranks
   must equal a dense count over the same block products; wall time and
   pairs/s.

Then one {"kernels": [...]} line and, last, {"ok": true, "device": ...}.
TF32 is off for matmuls and cuDNN alike: every f32 product is full f32.
Without a CUDA device it exits 1 and prints no result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SHAPES = [(4, 200), (145, 4), (4, 145)]  # (Lq, Lk) of the interaction stacks
PATH_LAUNCHES = {(4, 200): 3, (145, 4): 2, (4, 145): 2}  # per embed_images
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
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
    import torch
    import torch.nn.functional as F

    from leccr_torch.ops.fused_cross_attention import (
        fused_cross_attention,
        fused_cross_attention_reference,
    )

    flush_buf = torch.empty(2 ** 30, dtype=torch.uint8, device="cuda")
    flush = flush_buf.zero_
    results = []
    for lq, lk in SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            g = torch.Generator(device="cuda").manual_seed(lq * 1000 + lk)
            # the path's layout: [B, L, H, Dh] storage seen as [B, H, L, Dh]
            q, k, v = (torch.randn(batch, n, heads, dh, device="cuda",
                                   generator=g).to(dtype).transpose(1, 2)
                       for n in (lq, lk, lk))
            pad = torch.rand(batch, lk, device="cuda", generator=g) < 0.3
            pad[0] = True  # fully padded row: the mean of v
            pad[1] = False
            got = fused_cross_attention(q, k, v, pad)
            want = fused_cross_attention_reference(q, k, v, pad)
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs()
            err = diff.max().item()
            if not torch.isfinite(got).all():
                raise AssertionError(f"non-finite kernel output {lq}x{lk}")
            mean_v = v[0].float().mean(dim=1, keepdim=True).expand(-1, lq, -1)
            if (got[0].float() - mean_v).abs().max().item() > 1e-2:
                raise AssertionError("fully padded row is not the mean of v")
            if dtype == torch.float32:
                ok, tol = err <= 1e-5, "max abs err <= 1e-5"
            else:
                ok = bool((diff <= 1e-5 + bf16_ulp(want)).all())
                tol = "every element within 1e-5 + 1 bf16 ulp"
            if not ok:
                raise AssertionError(f"kernel disagrees with its plain "
                                     f"version at {lq}x{lk} {dtype}: {err}")
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
            name = str(dtype).split(".")[-1]
            t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / PEAK_FLOPS[name] * 1e3
            results.append({
                "lq": lq, "lk": lk, "dtype": name, "max_abs_err": err,
                "tolerance": tol, "ms": ms, "plain_ms": plain_ms,
                "library_ms": library_ms, "bytes": n_bytes, "flops": flops,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations"})
            emit("kernel_vs_plain", **results[-1])
    return results


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

    fused_cross_attention.launches = 0
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
         max_unit_norm_err=norm_err, top_hit=hits[0][0],
         top_hit_minmax=hits_mm[0][0])
    return emb, launches


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
    fused_cross_attention.launches = 0
    t0 = time.perf_counter()
    img, txt, (i2t, t2i), times = run()
    wall = time.perf_counter() - t0
    launches = fused_cross_attention.launches
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
         kernel_launches=launches,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         metrics=metrics)
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from leccr_torch.config import load_config
    from leccr_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card_line = card()
    print(card_line, flush=True)
    emit("device", card=card_line, torch=torch.__version__,
         cuda=torch.version.cuda, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())
    t0 = time.perf_counter()
    _build.load("fused_cross_attention")
    build_s, log = _build.build_info["fused_cross_attention"]
    emit("build", kernel="fused_cross_attention",
         wall_s=time.perf_counter() - t0, nvcc_s=build_s,
         ptxas=[ln.strip() for ln in log.splitlines() if "ptxas" in ln])

    shapes = kernel_phase()
    cfg = load_config(str(ROOT / "configs" / "multi30k_all.yaml"))
    model_check_phase(cfg)
    emb, serve_launches = serve_phase(cfg)
    eval_launches = eval_phase(emb, card_line)

    def path_sum(key):  # bf16 at B=64: one embed_images batch, 7 launches
        return sum(PATH_LAUNCHES[(r["lq"], r["lk"])] * r[key] for r in bf16)

    bf16 = [r for r in shapes if r["dtype"] == "bfloat16"]
    print(json.dumps({"kernels": [{
        "name": "fused_cross_attention",
        "route": "cuda",
        "source": "leccr_torch/csrc/fused_cross_attention.cu",
        "replaces": "leccr_tpu/ops/pallas_attention.py:26",
        "launches": serve_launches + eval_launches,
        "launches_serve": serve_launches,
        "launches_eval": eval_launches,
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
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
