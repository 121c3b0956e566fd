"""`benchmark.roofline` against the bounds of PERF.md's kernel table (the
shapes of PERF.md §6: the flagship step's kernels 2/3, the long-sequence
bs32 step's kernels 4/5, an embed_images batch's kernel 1), and the
launch counts the train steps make."""

import pytest
import yaml

from benchmark import roofline as r
from benchmark.reference.model import Arch
from benchmark.run import ROOT


def _arch(name):
    meta = yaml.safe_load((ROOT / "benchmark" / "configs" / f"{name}.yaml")
                          .read_text())
    return Arch.of(meta["config"]["model"])


def test_kernels_2_and_3_per_flagship_step():
    # 12 layers each: ViT-B/32 [128, 12, 145, 64] forward and backward, the
    # texts [256, 12, 64, 64] masked forward and backward, the captions
    # [128, 12, 64, 64] masked forward alone
    fwd = 12 * sum(r.flash_launch("fwd", *s)[0] for s in (
        (128, 12, 145, 64, False), (256, 12, 64, 64, True),
        (128, 12, 64, 64, True)))
    bwd = 12 * sum(r.flash_launch("bwd", *s)[0] for s in (
        (128, 12, 145, 64, False), (256, 12, 64, 64, True)))
    assert fwd == pytest.approx(0.9569, abs=5e-5)
    assert bwd == pytest.approx(1.3519, abs=5e-5)


def test_kernels_4_and_5_per_long_sequence_step():
    fwd = 48 * r.flash_launch("fwd", 32, 16, 577, 64, False, "chunked")[0]
    bwd = 24 * r.flash_launch("bwd", 32, 16, 577, 64, False, "chunked")[0]
    assert fwd == pytest.approx(2.1842, abs=5e-5)
    assert bwd == pytest.approx(2.6474, abs=5e-5)


def test_kernel_1_per_embed_images_batch():
    # PERF.md's row counts the key mask on every launch of the batch
    batch = sum(n * r.fca_launch(64, 8, lq, lk, 64, True)[0]
                for (lq, lk), n in {(4, 200): 3, (145, 4): 2,
                                    (4, 145): 2}.items())
    assert batch == pytest.approx(0.04728, abs=5e-5)
    # the eval's own launches read a mask only over the caption
    rows = r.eval_fca_launches(_arch("flagship"), 64, 200, 1)
    assert sum(n for _, n in rows) == 7
    assert sum(n * r.fca_launch(*s)[0] for s, n in rows) < batch


def test_train_step_launch_counts():
    flagship = r.train_launches(_arch("flagship"), 128, 64, 128)
    assert r.launch_counts(flagship) == {"single_fwd": 36, "single_bwd": 24,
                                         "chunk_fwd": 0, "chunk_bwd": 0}
    scale = r.train_launches(_arch("scale_vitl14"), 128, 64, 64)
    assert r.launch_counts(scale) == {"single_fwd": 72, "single_bwd": 24,
                                      "chunk_fwd": 48, "chunk_bwd": 24}


def test_model_flops_scale_with_the_work():
    a = _arch("flagship")
    step64 = r.train_step_flops(a, 128, 64, 128)
    step32 = r.train_step_flops(a, 128, 32, 128)
    assert 15e12 < step32 < step64 < 30e12
    assert r.train_step_flops(a, 256, 64, 128) == pytest.approx(2 * step64)
    assert 100e12 < r.eval_flops(a, 1000, 200, 5000, 64) < 140e12


@pytest.mark.parametrize("name, family", [
    ("void (anonymous namespace)::single_fwd_wgmma_kernel<10>(Params)",
     "single_fwd"),
    ("void single_bwd_wgmma_kernel<2>(P)", "single_bwd"),
    ("void chunk_bwd_dq_wgmma_kernel(Params)", "chunked"),
    ("void fca_few_queries_kernel<__nv_bfloat16>(Params)", "fca"),
    ("void infonce_stats_kernel(float const*)", "infonce"),
    ("ampere_bf16_s16816gemm_bf16_128x128_ldg8_f2f_stages_64x3_tn", None),
])
def test_kernel_families(name, family):
    assert r.kernel_family(name) == family


def test_share_has_no_reading_without_time():
    assert r.share([1.0], 0.0) is None
    assert r.share([1.0], 4.0) == pytest.approx(25.0)
