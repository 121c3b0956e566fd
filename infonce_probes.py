#!/usr/bin/env python3
"""Where kernels 9-11's time goes, on one card: build probe copies of
`leccr_torch/csrc/fused_infonce.cu` with one part taken out, time each
beside the source as built, and time cuBLAS's f32 GEMM as a yardstick of
the f32 rate a SIMT product reaches on the card.

    python3 infonce_probes.py          # from the repository root

A probe computes a wrong result by design: only "as_built" is checked
against the plain versions (`chip_smoke.infonce_check`).  The probes:
  stats_no_operand_reads  kernel 9's shared-memory operand reads made
                          invariant in the feature loop (the FMAs stay)
  stats_no_epilogue       kernel 9 without the per-tile epilogue (scale,
                          mask, running max and sum, ids)
  bwd_no_logits           kernels 10/11 without the logit product
  bwd_no_weighted_sum     kernels 10/11 without the w . other product
Each line: probe, shape, kernel, device ms (CUDA events, L2 flushed, as
chip_smoke times them), the grid launched.  Probes build into a
gitignored directory (`_checkout/probes/`), all side by side.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "_checkout" / "probes"
SHAPES = [(4096, 4096, "arange"), (32768, 32768, "arange")]
STATS_LOOP = ("a[r] = ld4(a_s + 16 * r * kChunkPitch + kk);",
              "b[c] = ld4(b_s + 16 * c * kChunkPitch + kk);")
PROBES = {
    "as_built": [],
    "stats_no_operand_reads": [
        (STATS_LOOP[0], "a[r] = ld4(a_s + 16 * r * kChunkPitch);"),
        (STATS_LOOP[1], "b[c] = ld4(b_s + 16 * c * kChunkPitch);")],
    "stats_no_epilogue": [
        ("if (step % chunks != chunks - 1) continue;",
         "if (step % chunks != chunks - 1 || acc[0][0] != 12345.f) "
         "continue;")],
    "bwd_no_logits": [
        ("for (int kk = 0; kk < e; kk += 4) {",
         "for (int kk = 0; kk < 0; kk += 4) {")],
    "bwd_no_weighted_sum": [
        ("for (int j = 0; j < kBwdCols; j += 4) {",
         "for (int j = 0; j < kBwdCols * (invt == 12345.f); j += 4) {")],
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("infonce_probes: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from leccr_torch.ops import _build, infonce

    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card(), flush=True)
    source = (_build.CSRC / "fused_infonce.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, edits in PROBES.items():
        text = source
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"probe {name}: {old!r} not in the source")
            text = text.replace(old, new)
        (OUT / f"{name}.cu").write_text(text)
        jobs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", str(OUT / f"lib{name}.so"), str(OUT / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, job in jobs.items():
        log = job.communicate()[0]
        if job.returncode:
            raise SystemExit(f"nvcc failed for probe {name}:\n{log}")
    flush = torch.empty(2 ** 30, dtype=torch.uint8, device="cuda").zero_
    libs = {name: ctypes.CDLL(str(OUT / f"lib{name}.so")) for name in PROBES}
    for m, n, ids in SHAPES:
        _build._loaded["fused_infonce"] = libs["as_built"]
        args, lse, pc = cs.infonce_check(m, n, ids)[:3]
        it = 3 if m * n > 2 ** 27 else 20
        for name in PROBES:
            _build._loaded["fused_infonce"] = libs[name]
            for kernel, fn in (
                    ("stats", lambda: infonce.infonce_stats(*args)),
                    ("dq", lambda: infonce.infonce_bwd_dq(*args, lse, pc)),
                    ("dk", lambda: infonce.infonce_bwd_dk(*args, lse, pc))):
                if name.startswith("stats") and kernel != "stats":
                    continue
                if name.startswith("bwd") and kernel == "stats":
                    continue
                print(json.dumps({
                    "probe": name, "m": m, "n": n, "kernel": kernel,
                    "ms": cs.cuda_ms(fn, flush, it),
                    "grid": infonce.last_grid[kernel]}), flush=True)
    for m, k, n in ((4096, 256, 4096), (8192, 8192, 8192)):
        a = torch.randn(m, k, device="cuda")
        b = torch.randn(k, n, device="cuda")
        ms = cs.cuda_ms(lambda: a @ b, flush, 10)
        print(json.dumps({"probe": "cublas_f32_gemm", "m": m, "k": k,
                          "n": n, "ms": ms,
                          "tflops": 2 * m * k * n / ms * 1e-9}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
