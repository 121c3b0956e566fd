"""Typed configuration for leccr_torch.

The port's own copy of the JAX package's config module (it imports nothing
from `leccr_tpu`), so the same `configs/*.yaml` files load unchanged.

The reference config system is an untyped ruamel-YAML dict whose keys are
partially ignored by the code (e.g. `use_swin`/`vision_config`/`text_encoder`
are read from YAML but the towers are hard-coded, see
reference models/xvlm.py:83-103 and SURVEY.md §5).  Here the tower choice is
*real*: every field in this config is honored by the model builders.

YAML files map 1:1 onto the dataclasses below; unknown keys are an error so
configs can't silently rot.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional


def _build(cls, data: Dict[str, Any]):
    """Construct a (possibly nested) dataclass from a dict, strictly."""
    if data is None:
        data = {}
    names = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(data) - set(names)
    if unknown:
        raise ValueError(f"unknown config keys for {cls.__name__}: {sorted(unknown)}")
    kwargs = {}
    for key, value in data.items():
        f = names[key]
        if dataclasses.is_dataclass(f.type) or (
            isinstance(f.type, str) and f.type in _DATACLASS_REGISTRY
        ):
            sub = _DATACLASS_REGISTRY[f.type] if isinstance(f.type, str) else f.type
            kwargs[key] = _build(sub, value) if isinstance(value, dict) else value
        else:
            kwargs[key] = value
    return cls(**kwargs)


@dataclass
class VisionConfig:
    """Vision tower. `kind` selects the real implementation.

    - "clip_vit": OpenAI-CLIP-architecture ViT (reference clip/model.py:206-240,
      340-346); `variant` picks the published size. The reference hard-codes
      ViT-B/32 at 384x384 with interpolated position embeddings
      (clip/model.py:414-419).
    - "temporal": self-attention encoder over precomputed per-frame features
      (reference models/video_model_retrieval_caption.py:27-34).
    """

    kind: str = "clip_vit"  # clip_vit | temporal
    variant: str = "ViT-B/32"  # ViT-B/32 | ViT-B/16 | ViT-L/14 (clip_vit only)
    # fused Pallas attention (see TextConfig.fused_attention); TPU-only
    fused_attention: bool = False
    image_res: int = 384
    # temporal tower (video): input per-frame feature dim and depth
    frame_feat_dim: int = 4096
    num_layers: int = 1
    num_heads: int = 8
    max_frames: int = 32
    # test-size overrides (0 = use variant defaults)
    width: int = 0
    depth: int = 0

    @property
    def patch_size(self) -> int:
        return int(self.variant.split("/")[-1]) if "/" in self.variant else 32


@dataclass
class TextConfig:
    """Multilingual text tower (BERT-family encoder).

    The reference hard-codes `bert-base-multilingual-cased`
    (models/xvlm.py:91-103). We keep the same architecture family but the
    size is configurable (for tests and for XLM-R-large scale-up).
    """

    kind: str = "bert"  # bert | xlmr (same arch; different vocab/tokenizer)
    vocab_size: int = 119547  # bert-base-multilingual-cased
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0
    # fuse QK^T -> mask -> softmax -> dropout -> PV into one Pallas kernel
    # per batch item (ops/flash_attention.py); TPU-only, falls back to the
    # XLA attention elsewhere.  Keeps [B,H,L,L] probabilities and dropout
    # masks out of HBM entirely (the bwd regenerates the mask from the seed)
    fused_attention: bool = False


@dataclass
class ModelConfig:
    """LECCR retrieval head (reference models/model_retrieval_caption.py)."""

    vision: VisionConfig = field(default_factory=VisionConfig)
    text: TextConfig = field(default_factory=TextConfig)
    embed_dim: int = 256
    temp: float = 0.07
    caption_encoder_name: str = "mbert"  # mbert (shared w/ text tower) | clip
    num_queries: int = 4
    caption_ca_layer: int = 3
    caption_interaction_layer: int = 2
    weight_caption_loss: float = 0.01
    weight_reg_loss: float = 0.01
    weight_dstl_loss: float = 0.5
    weight_cv_loss: float = 0.01
    dstl_alpha: float = 0.8
    # Caption-vision loss normalization axis.  The reference calls
    # F.normalize with its DEFAULT dim=1, i.e. it normalizes cproj/vproj
    # outputs across the TOKEN axis, not the feature axis
    # (model_retrieval_caption.py:118-126, video_…caption.py:144-150 —
    # almost certainly an accident of the default, but it is what the
    # model trains with).  1 = faithful reference behavior (default);
    # -1 = feature-axis cosine variant.
    cv_normalize_dim: int = 1
    # Video caption-vision loss frame pooling: the reference plain-means the
    # temporal-encoder outputs INCLUDING padded frame positions
    # (video_model_retrieval_caption.py:144-160); True (default) uses the
    # masked mean instead — strictly more correct, identical when batches
    # are unpadded.  Set False to reproduce reference trajectories exactly.
    video_cv_mask_frames: bool = True
    dropout: float = 0.1
    use_one_cl_proj_only: bool = False
    # compute dtype for the towers; params & loss math stay fp32
    dtype: str = "bfloat16"
    # run the caption-interaction attention as fused Pallas kernels in the
    # no-grad eval path (TPU only; training always uses XLA attention)
    fused_eval_attention: bool = True
    # rematerialize tower blocks in the backward pass (jax.checkpoint; in
    # the port torch.utils.checkpoint per block, ops/dropout.py
    # checkpoint_block): trades ~30% more FLOPs for O(layers) less
    # activation memory — required for the 32k-negative scale config
    remat: bool = False
    # run tower depth as lax.scan over stacked layer params (weight import
    # via convert.*(scan=True)): shrinks the HLO ~num_layers x — useful for
    # very deep towers (ViT-L/XLM-R-large).  For TRAINING combine with
    # remat=True — plain scan stacks every layer's attention residuals for
    # the backward pass and blows HBM; eval/serving is fine without.
    # Measured on v5e @ ViT-B scale: compile ~parity, step +25% (remat).
    scan_layers: bool = False


@dataclass
class DataConfig:
    """Datasets in the reference layout (SURVEY.md §2 #10-13)."""

    dataset: str = "multi30k"  # multi30k | mscoco | video | synthetic
    root_dir: str = ""
    train_file: List[str] = field(default_factory=list)
    val_file: Dict[str, str] = field(default_factory=dict)
    test_file: Dict[str, str] = field(default_factory=dict)
    test_trans_file: Optional[str] = None
    image_root: str = ""
    generated_caption_dir: str = ""
    generated_caption_type: str = "caption"  # caption | feats
    max_words: int = 30
    max_tokens: int = 200
    # static-shape buckets for tokenized text (avoids per-step recompiles;
    # reference pads to `longest` per step, image_Retrieval_caption.py:47)
    token_buckets: List[int] = field(default_factory=lambda: [32, 64, 128])
    num_workers: int = 4
    # libjpeg DCT pre-scaled decode (Image.draft): 2-13x faster host decode
    # (measured scripts/profile_pipeline.py), NOT pixel-identical to the
    # reference's full-resolution decode+crop — off for strict parity
    fast_decode: bool = False
    # tokenizer vocab files (offline; no network)
    text_vocab: str = ""  # WordPiece vocab.txt for the text tower
    clip_bpe_vocab: str = ""  # CLIP BPE merge file (optional, caption_encoder=clip)
    lowercase: bool = False  # mBERT-cased => False
    # RandAugment policy (reference dataset/randaugment.py; off in the live
    # fine-tune transform, available for the pretrain transform)
    randaugment: bool = False
    randaugment_n: int = 2
    randaugment_m: int = 7
    # Keep decoded eval batches resident in HBM across epochs (uint8 +
    # caption tokens), up to this budget.  The eval set is fixed, so every
    # per-epoch eval after the first skips host decode + the host->device
    # image upload entirely (at Multi30K scale that upload is 442 MB and
    # dominates eval wall time over a remote transport).  0 disables.
    # Admission is FIRST-COME, whole-split, no eviction: the splits
    # evaluated first own the budget for the run; later splits simply take
    # the (correct, slower) uncached path each epoch.  Deliberate — every
    # epoch evaluates all splits in the same order, so LRU would evict A to
    # admit Z and then miss A again next epoch (thrash: nobody gets a hit),
    # while first-come gives the admitted splits stable hits every epoch.
    # Size the budget to the splits you eval most (or set 0) for
    # multilingual-all runs; see DESIGN.md "Eval HBM cache admission".
    cache_eval_on_device_mb: int = 2048
    # synthetic dataset knobs (tests/bench)
    synthetic_size: int = 128
    synthetic_eval_images: int = 64
    synthetic_captions_per_image: int = 5
    # concept-structured (color <-> word) synthetic data: held-out
    # retrieval is learnable, so train-to-convergence checks can assert
    # test sumR approaches its ceiling (see data/synthetic.py)
    synthetic_learnable: bool = False
    seed: int = 42


@dataclass
class OptimConfig:
    """AdamW + 4 param groups (reference optim.py:8-65)."""

    lr: float = 1e-5
    weight_decay: float = 0.01
    lr_mult: float = 2.0  # multiplier for params matching lr_mult_paths
    # regexes over param paths that get lr x lr_mult.  Default empty = the
    # live reference behavior (its init_params list is reset to [] after
    # construction, model_retrieval_caption.py:14, so the mult group is
    # empty in practice); set e.g. ["caption_query_attn", "queries"] to
    # give the from-scratch head a higher LR like the reference intended.
    lr_mult_paths: List[str] = field(default_factory=list)
    betas: List[float] = field(default_factory=lambda: [0.9, 0.98])
    eps: float = 1e-8
    # Reference-compatible update rule: the reference pins transformers 4.12
    # (requirements.txt), whose AdamW adds eps to the UNCORRECTED sqrt(v) and
    # bias-corrects the step size (optim.py:63).  Modern AdamW (optax/torch)
    # adds eps to the bias-corrected sqrt(vhat); the two diverge on
    # small-gradient params during the first steps.  Off by default (modern
    # semantics); switch on to reproduce reference trajectories exactly.
    legacy_eps: bool = False
    # Storage dtype of the Adam moments ("float32" | "bfloat16").  With
    # "bfloat16" the mu/nu trees are stored at half width — update math
    # still runs in f32 and the params stay f32 master weights — halving
    # the optimizer-state HBM read+write that round-3 xprof attribution
    # identified as part of the train-step floor.  legacy_eps stores BOTH
    # moments at the chosen dtype; the optax path casts mu only (optax
    # adamw has no nu_dtype).  Changes trajectories at the rounding level:
    # keep float32 for reference-parity runs, use bfloat16 for throughput.
    moment_dtype: str = "float32"


@dataclass
class SchedConfig:
    """Linear warmup → linear decay, stepped per optimizer step
    (reference scheduler.py:4-28)."""

    epochs: int = 50
    num_warmup_steps: float = 0.1  # int steps or float fraction


@dataclass
class ParallelConfig:
    """Mesh layout. `data` is the batch axis (ICI); `model` shards tower
    weights for large variants. Reference had DP only (SURVEY.md §2c)."""

    data: int = -1  # -1 = all devices
    model: int = 1
    # number of DCN-connected slices the data axis spans (multi-slice pod).
    # Purely a device-ordering hint: slice-major order keeps model-parallel
    # groups inside a slice and makes the data-axis gradient reduce
    # hierarchical (ICI within a slice, DCN across). 1 = single slice.
    dcn_data: int = 1
    # fully-sharded data parallel (ZeRO-3): shard params + Adam moments
    # over the data axis too; XLA all-gathers weights at use and
    # reduce-scatters grads. Cuts per-chip state HBM ~data× — required for
    # the video model past bs64/chip (11 GB fp32 state on one chip).
    fsdp: bool = False
    # params below this many elements stay replicated under fsdp: gathering
    # a few KB per layer costs more in collective latency than it saves
    # (dryruns/tests drop it to 1 so tiny towers genuinely shard)
    fsdp_min_size: int = 1 << 16
    # global-negatives strategy for the contrastive losses:
    #  "gather":     all_gather features (reference AllGather semantics)
    #  "ring":       ppermute ring, never materializes the full logits
    #  "ring_fused": ring whose per-rotation blocks run through the fused
    #                Pallas InfoNCE kernels (logits stay in VMEM)
    #  "fused":      single-device fused blockwise InfoNCE
    negatives: str = "gather"
    # stream the dstl/caption-vision losses in row blocks of this many rows
    # (0 = dense; automatically 256 when negatives == "ring")
    stream_loss_block_rows: int = 0


@dataclass
class TrainConfig:
    batch_size_train: int = 128  # global batch
    batch_size_test: int = 64
    batch_size_test_text: int = 256
    seed: int = 42
    # PRNG implementation for the in-step dropout keys.  "rbg" samples the
    # masks with the TPU-native hardware RNG while still deriving keys with
    # threefry (fold_in/split) — measured 137 -> 114 ms/step at bs64 on v5e
    # (threefry mask generation alone was ~17% of the step).  "threefry"
    # restores the classic JAX stream bit-for-bit.
    rng_impl: str = "rbg"
    optimizer: OptimConfig = field(default_factory=OptimConfig)
    schedular: SchedConfig = field(default_factory=SchedConfig)  # ref spelling
    log_every: int = 50
    checkpoint_every_epochs: int = 1
    keep_checkpoints: int = 2
    resume: bool = False
    grad_clip: float = 0.0  # 0 = off (reference has none)
    # score fusion at eval: "auto" = plain cosine for images
    # (reference evaluation_coarse) and min-max double-sim for video
    # (video_…py:169-179); "raw" = the image alpha-blend variant
    # (image_…py:244-246); "none"/"minmax" force a mode.
    eval_fusion: str = "auto"
    eval_alpha: float = 0.9
    # crash/preemption safety: also checkpoint every N optimizer steps
    # (0 = per-epoch only); resume restarts from the owning epoch
    checkpoint_every_steps: int = 0
    # raise at the producing op on any NaN under jit (jax_debug_nans)
    debug_nans: bool = False
    # GradCache (two-pass exact large-batch contrastive): split the
    # per-step batch into M microbatches; towers forward once without
    # activation residency, the loss differentiates against the
    # concatenated embeddings (tiny), then each microbatch re-runs its
    # tower vjp with the embedding-grad slice injected. The gradient is
    # EXACT (same objective, global negatives included) while tower
    # activation memory drops M×: the negative-pool size decouples from
    # activation HBM at the price of one extra forward (~4/3 step FLOPs).
    # 0/1 = off.
    grad_cache_microbatches: int = 0
    # EMA of the params (beyond reference; a standard quality lever for
    # contrastive retrieval).  0 disables.  When enabled: the jitted step
    # also advances ema = decay*ema + (1-decay)*params (seeded from the
    # init weights, no bias correction needed), eval + best-ckpt gating
    # run on the EMA weights when ema_eval is true, checkpoints carry
    # "ema_params", and serving/export prefer them.  Resuming a non-EMA
    # checkpoint with EMA enabled re-seeds the EMA from the restored
    # params; resuming with EMA disabled simply ignores the stored EMA.
    ema_decay: float = 0.0
    ema_eval: bool = True


@dataclass
class LECCRConfig:
    task: str = "itr_caption"  # itr_caption | vtr_caption | serve
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    output_dir: str = "output"
    # set when the user passed an hdfs:// output dir: output_dir becomes a
    # local staging dir and the trainer mirrors checkpoints + log.txt +
    # config.json up after every checkpointed epoch (reference
    # utils/torch_io.py:15-31 + utils/checkpointer.py:20-46 flow)
    remote_output_dir: str = ""

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    def save(self, path: str) -> None:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        Path(path).write_text(self.to_json())

    @staticmethod
    def from_dict(data: Dict[str, Any]) -> "LECCRConfig":
        return _build(LECCRConfig, data)


_DATACLASS_REGISTRY = {
    c.__name__: c
    for c in (
        VisionConfig,
        TextConfig,
        ModelConfig,
        DataConfig,
        OptimConfig,
        SchedConfig,
        ParallelConfig,
        TrainConfig,
        LECCRConfig,
    )
}


def load_config(path: str) -> LECCRConfig:
    """Load a YAML or JSON config file into a LECCRConfig."""
    text = Path(path).read_text()
    if path.endswith(".json"):
        data = json.loads(text)
    else:
        import yaml

        data = yaml.safe_load(text)
    return LECCRConfig.from_dict(data)


def tiny_test_config(**overrides: Any) -> LECCRConfig:
    """A small config that runs fast on CPU — used across the test suite."""
    cfg = LECCRConfig(
        model=ModelConfig(
            vision=VisionConfig(kind="clip_vit", variant="ViT-B/32", image_res=64,
                                width=64, depth=2),
            text=TextConfig(vocab_size=512, hidden_size=64, num_layers=2,
                            num_heads=4, intermediate_size=128,
                            max_position_embeddings=64),
            embed_dim=32,
            num_queries=4,
            caption_ca_layer=1,
            caption_interaction_layer=1,
            dtype="float32",
        ),
        data=DataConfig(dataset="synthetic", max_tokens=16,
                        token_buckets=[16], synthetic_size=32,
                        synthetic_eval_images=8),
        train=TrainConfig(batch_size_train=8, batch_size_test=8,
                          batch_size_test_text=16),
    )
    for key, value in overrides.items():
        node = cfg
        parts = key.split(".")
        for part in parts[:-1]:
            node = getattr(node, part)
        setattr(node, parts[-1], value)
    return cfg
