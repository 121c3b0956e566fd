"""The port stands alone: importing every leccr_torch module pulls in no
JAX, flax, optax, leccr_tpu, safetensors or transformers module, and
builds nothing: no CUDA kernel, no native tokenizer library."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

_SCRIPT = """
import importlib, json, pkgutil, sys
import leccr_torch
from leccr_torch.ops import _build
from leccr_torch.data import native_tokenizer
names = [m.name for m in pkgutil.walk_packages(leccr_torch.__path__,
                                                "leccr_torch.")]
for name in names:
    importlib.import_module(name)
print(json.dumps({
    "modules": names,
    "foreign": sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                             "optax", "leccr_tpu",
                                             "safetensors", "transformers",
                                             "regex")),
    "built": sorted(_build.build_info),
    "native_loaded": native_tokenizer._lib is not None,
}))
"""


def test_port_imports_no_jax_and_builds_nothing():
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert {"leccr_torch.serve", "leccr_torch.eval.retrieval",
            "leccr_torch.ops.fused_cross_attention",
            "leccr_torch.models.weights", "leccr_torch.ops.dropout",
            "leccr_torch.ops.flash_attention", "leccr_torch.models.losses",
            "leccr_torch.train.optim", "leccr_torch.train.schedule",
            "leccr_torch.train.step", "leccr_torch.data.pipeline",
            "leccr_torch.data.datasets", "leccr_torch.data.synthetic",
            "leccr_torch.data.text", "leccr_torch.train.trainer",
            "leccr_torch.train.checkpoints", "leccr_torch.train.metrics",
            "leccr_torch.utils.io", "leccr_torch.utils.debug",
            "leccr_torch.run", "leccr_torch.data.tokenizers",
            "leccr_torch.data.native_tokenizer", "leccr_torch.models.clip",
            "leccr_torch.models.convert", "leccr_torch.serve_ann",
            "leccr_torch.serve_frontend", "leccr_torch.data.randaugment",
            "leccr_torch.parallel.mesh",
            "leccr_torch.parallel.ring"} <= set(out["modules"])
    assert out["foreign"] == []
    assert out["built"] == []
    assert not out["native_loaded"]


def test_library_name_hashes_only_the_headers_a_source_includes(
        tmp_path, monkeypatch):
    """A header edit renames (so rebuilds) only the libraries whose source
    includes it, directly or through another header."""
    from leccr_torch.ops import _build

    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "outer.cuh").write_text('#include "inner.cuh"\n')
    (tmp_path / "inner.cuh").write_text("// v1\n")
    (tmp_path / "other.cuh").write_text("// v1\n")
    (tmp_path / "uses.cu").write_text(
        '#include <cuda_runtime.h>\n  #  include "outer.cuh"\n')
    (tmp_path / "plain.cu").write_text("#include <stdint.h>\n")
    assert [h.name for h in _build.local_headers(tmp_path / "uses.cu")] == [
        "inner.cuh", "outer.cuh"]
    assert _build.local_headers(tmp_path / "plain.cu") == []
    before = {n: _build.library_path(n) for n in ("uses", "plain")}
    (tmp_path / "other.cuh").write_text("// v2\n")
    assert {n: _build.library_path(n) for n in ("uses", "plain")} == before
    (tmp_path / "inner.cuh").write_text("// v2\n")
    assert _build.library_path("uses") != before["uses"]
    assert _build.library_path("plain") == before["plain"]
