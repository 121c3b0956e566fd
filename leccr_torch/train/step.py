"""One training step: the port of the train step of
`leccr_tpu/train/trainer.py` (`_make_train_step` with `_grad_cache_grads`
and the EMA), on one device or as one rank of a data-parallel world.

    step = make_train_step(cfg, model, total_steps)
    losses = step(batch, step_no)   # dict of the 10 loss keys, as floats
    values = step.run(batch, step_no)  # the same, a [10] tensor, not read back

Each step builds its random streams from (cfg.train.seed + 17, step_no,
rank), preprocesses the uint8 images on the device (RandAugment when on,
normalize, per-image flip;
video frames go in as they are), runs the model forward in training mode,
computes the loss suite, takes the gradient of the `grad_total` objective
(the DDP-parity weighting of the JAX trainer; with num_blocks = 1 it
equals `total`), clips by global norm
when `train.grad_clip` > 0, and takes one optimizer and one scheduler step.
`step(...)` reads the losses back from the device once, as one tensor;
`step.run(...)` leaves them there.

`train.ema_decay` = d > 0: after the optimizer step the EMA of the
parameters advances, ema = ema·d + p·(1−d) in f32 over the parameter list
(`step.ema`, seeded from a copy of the parameters).

`train.debug_nans`: the forward and backward run in autograd's anomaly
mode, and the losses and gradients are checked finite after each step
(`utils.debug`).

`train.grad_cache_microbatches` = m > 1 takes the gradient by GradCache
(`grad_cache_backward`): the loss sees the whole batch as negatives while
the towers hold one microbatch's activations at a time.

`parallel.negatives`: `fused` routes the three ITC losses through the
fused InfoNCE kernels 9-11 (`ops.infonce.infonce_loss`; the [B, B] logits
never exist).  `ring` and `ring_fused` take the ring InfoNCE
(`parallel.ring`, dense blocks or kernels 9-11) across blocks: over the
processes of a `mesh`, or replayed in one process at num_blocks > 1, as
JAX's trainer does on its mesh (trainer.py:342-359); on one block without a
mesh they are the dense losses.  `ring` sets the streaming rows to 256
when the config leaves them at 0.  `parallel.stream_loss_block_rows`
streams dstl and the caption-vision loss in row blocks when it divides a
larger batch.

Data parallelism (`mesh`, a `parallel.mesh.DataMesh` of W processes, one
per device; num_blocks = W): each rank runs its own rows through the
towers; the gathered terms of `grad_total` see the world's batch in rank
order (`parallel.mesh.all_gather_rows`: each rank's gradient is its rows'
share), the temperature's cotangent is divided by W (every rank's loss
graph reads all of it), and after the backward the ranks' gradients are
summed (`all_reduce_grads`), so the update equals the one-process
`TrainStep(num_blocks=W)` on the concatenated batch and JAX's on a W-device
data mesh.  The losses are the same bits on every rank.  Dropout, flash
seeds and RandAugment draws come from (seed, step, rank[, k]).

Tensor parallelism (`parallel.model` = M > 1; the mesh's model groups):
the model is sharded in place (`parallel.tensor.shard_model`) before the
optimizer is built, so the optimizer, the EMA and `mu_dtype` step each
rank's slices.  Every model rank of data rank d draws the random streams
of d, so the replicated activations get one dropout mask, and a sharded
activation takes its slice of the one-process mask (`lean_dropout`'s
shard); the flash kernels take each rank's head offset.  The data axis
is the mesh's data group: the gathered negatives, the ring, the
temperature's 1/W and the gradient sum are over the data ranks, and every
model rank of a data rank computes the same losses on the same rows.
After the backward, the column-parallel biases' gradients are summed over
the model group (`sum_column_bias_grads`), every gradient over the data
group, and the clip norm counts each slice once (`clip_by_global_norm`).
So a step at data D × model M equals the one-process
`TrainStep(num_blocks=D)` on the same global batch within f32 sum-order
noise, with the same dropout bits.

FSDP (`parallel.fsdp`; `parallel.fsdp.shard_fsdp`): after the model
axis, each parameter of at least `parallel.fsdp_min_size` elements is cut
over the data ranks by the JAX layout, before the optimizer is built, so
the Adam moments (and `mu_dtype`'s bf16 first moment) and the EMA are
kept per shard.  The weights are gathered at use and the gradients
reduce-scattered, so those parameters' gradients arrive summed over the
data ranks: `all_reduce_grads` skips them, and the clip norm counts each
data shard once.  Over a mesh the group is the data group; in one process
at num_blocks = D > 1 it is `LocalDataGroup(D)` (the D shards stacked on
one device), and the step equals the step without FSDP bit for bit when
the clip is off (the flagship's).  At one data rank FSDP shards nothing,
as in the JAX package.

`data.randaugment`: the RandAugment policy of `data.randaugment_n` ops at
magnitude `data.randaugment_m` after /255 (`data.images.
preprocess_train_images`), drawn from the step's (or each microbatch's)
`Generators.aug`; video frames skip it.

CUDA graphs: on a CUDA device, where `graph_declines` finds nothing in the
step's layout that a graph cannot hold, each input signature (the batch's
keys, shapes and dtypes) runs eagerly the first time it is seen and is
captured the second: forward (with the preprocessing), loss, backward
and optimizer, one CUDA graph each, replayed at once and on every later
step of that signature, so the host launches four graphs a step instead
of thousands of kernels.  Every signature's graphs share one memory pool:
a replay runs its four phases back to back, and no two replay at once,
so the pool grows to the largest signature's working set (and each
signature's gradients and losses), not their sum.  A replay copies the
batch into the graphs' input buffers, reseeds the step's device
generator (registered with the forward's graph) with the eager step's
seed, draws the flash-attention seeds on the host in the order the
forward drew them and stages them into the slots the kernels read
(`ops.dropout.SeedSlots`), and stages the learning rates the optimizer
reads; so a replayed step computes the eager step's bits.  AdamW runs
capturable here, eagerly too, with its learning rate read from a device
tensor while it steps (its `param_groups` keep the schedule's floats).
Gradients live in the pool between replays.

What the first, eager step of a signature shows decides whether it is
captured: a step that launched kernels 4-8 with dropout on (they take
their seed by value, which a graph would freeze) stays eager, and so
does one for which the device, after its cached blocks are handed back,
lacks room for the pool to grow to twice that step's own peak (less what
the pool holds free) and then for an eager step of the largest peak
seen; so a signature that stays eager still has the room it had.  Every
capture runs on the step's one capture stream (the allocator hands a
capture the pool's free blocks only on the stream that freed them), with
the garbage collector off (a dropped step's graphs destroyed mid-capture
would end it).  A failed capture raises.  Loading the optimizer's state
or setting `ema` drops the graphs.  Counters: `graph_captures`,
`graph_replays`, `eager_steps` and `graph_pool_bytes`; `graph_skips`
says why a seen signature stays eager; span `train.graph` around each
replay, inside its phase's span.
"""

from __future__ import annotations

import dataclasses
import gc
import weakref
from typing import Callable, Dict, List, Optional, Tuple

import torch

from leccr_torch.config import LECCRConfig, ModelConfig
from leccr_torch.data.images import preprocess_train_images
from leccr_torch.models.leccr import LECCRModel, TrainEmbeddings
from leccr_torch.models.losses import LOSS_KEYS, compute_losses
from leccr_torch.ops import add_launch_counts, launch_counts
from leccr_torch.ops.dropout import Generators, SeedSlots
from leccr_torch.ops.flash_attention import flash_tower_attention
from leccr_torch.ops.infonce import infonce_loss
from leccr_torch.parallel.mesh import (
    DataMesh,
    all_gather_rows,
    all_reduce_grads,
    check_layout,
    scale_grad,
)
from leccr_torch.parallel.fsdp import (
    LocalDataGroup,
    ProcessDataGroup,
    fsdp_params,
    shard_fsdp,
)
from leccr_torch.parallel.ring import ring_infonce, ring_infonce_local
from leccr_torch.parallel.tensor import (
    shard_model,
    sharded_params,
    sum_column_bias_grads,
)
from leccr_torch.train.optim import build_optimizer, clip_by_global_norm
from leccr_torch.train.schedule import linear_warmup_decay
from leccr_torch.utils import tracing
from leccr_torch.utils.debug import assert_all_finite, nan_checks
from leccr_torch.utils.tracing import span

_U64 = 2 ** 64 - 1


def _of_rank(seed: int, rank: int) -> int:
    """A stream seed of `rank`: rank 0 keeps `seed`, so a one-process run
    draws what it drew before ranks existed."""
    return seed if rank == 0 else (seed ^ (rank * 0x9E3779B97F4A7C15)) & _U64


def step_generators(seed: int, step_no: int, device,
                    rank: int = 0) -> Generators:
    """The random streams of step `step_no` of rank `rank` of a run seeded
    with `seed`."""
    return Generators.from_seed(_of_rank((seed << 32) + step_no, rank),
                                device)


def microbatch_generators(seed: int, step_no: int, k: int, device,
                          rank: int = 0) -> Generators:
    """The random streams of microbatch `k` of step `step_no` of rank
    `rank` under GradCache: one stream per microbatch, as the JAX trainer
    folds k into the step's keys (trainer.py:385-390)."""
    if not 0 <= k < 0xFFFF:
        raise ValueError(f"microbatch {k} out of range")
    return Generators.from_seed(_of_rank(
        ((((seed << 32) + step_no) << 16) + k + 1) & _U64, rank), device)


def grad_total(losses: Dict[str, torch.Tensor], mc: ModelConfig,
               num_blocks: int = 1, cv_loss_local: bool = False
               ) -> torch.Tensor:
    """The objective the JAX trainer differentiates: the gathered
    (global-negative) terms scaled by 1/num_blocks plus the per-block local
    terms (caption contrastive and regularization, and for video, where
    `cv_loss_local`, the caption-vision loss), so that a DDP mean of
    per-rank gradients equals the reference's (trainer.py:421-431)."""
    gathered = (losses["raw_itc_vs"]
                + losses["raw_itc_vt"] * (1 - mc.weight_dstl_loss)
                + losses["loss_itc_st"] + losses["raw_dstl"])
    local = losses["loss_itc_c"] + losses["loss_reg_c"]
    if cv_loss_local:
        local = local + losses["raw_cv"]
    else:
        gathered = gathered + losses["raw_cv"]
    return gathered / num_blocks + local


def grad_cache_backward(
    model: LECCRModel,
    batch: Dict[str, torch.Tensor],
    gens: List[Generators],
    objective: Callable[[TrainEmbeddings],
                        Tuple[torch.Tensor, Dict[str, torch.Tensor]]],
    randaugment_n: int = 0,
    randaugment_m: int = 7,
) -> Dict[str, torch.Tensor]:
    """GradCache (Gao et al., arXiv 2101.06983; `_grad_cache_grads`,
    trainer.py:58-120): the exact gradient of `objective` over the whole
    batch, holding one microbatch's tower activations at a time.

    batch: the model's inputs plus "flip" (optional), cut into
    len(gens) = m equal microbatches; microbatch k draws from gens[k].
    objective(emb) -> (scalar to differentiate, losses) on the whole
    batch's embeddings.  Three passes:

      1. forward each microbatch without a graph (training mode, dropout
         on) and concatenate the 8 TrainEmbeddings fields; temp is the
         same in every microbatch;
      2. differentiate the objective on the concatenated fields alone
         (no tower is involved): their cotangents;
      3. forward each microbatch again with a graph and back-propagate its
         slice of the cotangents (temp's divided by m: every microbatch's
         forward reads the same temp), accumulating into the parameters'
         `.grad`.

    Pass 3 must draw exactly the dropout bits, flash seeds and RandAugment
    draws pass 1 drew, or the gradient is of other masks and images and
    nothing reports it: each microbatch's generators are set back to their
    state before pass 1.  Returns the losses of pass 2."""
    m = len(gens)
    b = next(iter(batch.values())).shape[0]
    if b % m:
        raise ValueError(f"batch {b} does not split into {m} microbatches")
    rows = [slice(k * (b // m), (k + 1) * (b // m)) for k in range(m)]
    flip = batch.get("flip")
    inputs = {key: v for key, v in batch.items() if key != "flip"}

    video = "vision_mask" in inputs

    def forward(k: int) -> TrainEmbeddings:
        with span("train.forward"):
            mb = {key: v[rows[k]] for key, v in inputs.items()}
            if not video:
                mb["vision"] = preprocess_train_images(
                    mb["vision"], None if flip is None else flip[rows[k]],
                    gens[k].aug, randaugment_n, randaugment_m)
            return model(mb, gens[k])

    states = [g.get_state() for g in gens]
    with torch.no_grad():
        embs = [forward(k) for k in range(m)]
    names = [f.name for f in dataclasses.fields(TrainEmbeddings)]
    fields = {n: (embs[0].temp if n == "temp"
                  else torch.cat([getattr(e, n) for e in embs]))
              .detach().requires_grad_(True) for n in names}
    del embs
    with span("train.loss"):
        value, losses = objective(TrainEmbeddings(**fields))
    with span("train.backward"):
        value.backward()
    cots = {n: f.grad for n, f in fields.items() if f.grad is not None}
    del fields
    for k in range(m):
        gens[k].set_state(states[k])
        emb = forward(k)
        pairs = [(getattr(emb, n), g / m if n == "temp" else g[rows[k]])
                 for n, g in cots.items() if getattr(emb, n).requires_grad]
        with span("train.backward"):
            torch.autograd.backward([t for t, _ in pairs],
                                    [g for _, g in pairs])
    return {key: v.detach() for key, v in losses.items()}


@torch.no_grad()
def ema_update_(ema: List[torch.Tensor], params: List[torch.Tensor],
                decay: float) -> None:
    """ema = ema·decay + p·(1−decay), in place, in f32 (the JAX trainer's
    update, trainer.py:446-451)."""
    torch._foreach_mul_(ema, decay)
    torch._foreach_add_(ema, [p.float() for p in params], alpha=1 - decay)


def graph_declines(cfg: LECCRConfig, device, mesh: Optional[DataMesh] = None,
                   num_blocks: int = 1) -> List[str]:
    """Why a train step of `cfg` on `device` runs every step eagerly and
    never as CUDA graphs; [] where graphs may engage.  A graph replays
    fixed launches on fixed buffers: it cannot hold work that the host
    decides anew each step, waits for, or shares with other processes."""
    tc, mc = cfg.train, cfg.model
    why = []
    if torch.device(device).type != "cuda":
        why.append("not a CUDA device")
    if mesh is not None:
        why.append("a mesh: collectives with other processes")
    if num_blocks > 1:
        why.append("blocks replayed in one process")
    if tc.grad_cache_microbatches > 1:
        why.append("GradCache: microbatches replay their generators' states")
    if cfg.data.randaugment:
        why.append("RandAugment: control flow drawn on the host")
    if tc.debug_nans:
        why.append("debug_nans: anomaly mode and checks on the host")
    if mc.vision.kind == "temporal":
        why.append("video frames")
    if mc.remat:
        why.append("remat: the recompute sets its generators' states back")
    return why


def _loss_vector(losses: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The losses as a [len(LOSS_KEYS)] f32 tensor, detached."""
    return torch.stack([losses[k].detach().float() for k in LOSS_KEYS])


@dataclasses.dataclass
class StepGraphs:
    """The CUDA graphs of one input signature: its input buffers, the
    slots of its flash-attention seeds, (span name, graph, launches of
    each kernel counter that its capture made) for each phase in order,
    the [len(LOSS_KEYS)] losses it writes and the gradients it leaves."""

    inputs: Dict[str, torch.Tensor]
    idx: torch.Tensor
    seeds: SeedSlots
    phases: List[Tuple[str, "torch.cuda.CUDAGraph", Dict]]
    out: torch.Tensor
    grads: List[torch.Tensor]


def check_parallel(cfg: LECCRConfig, world: int = 1) -> None:
    """Raise for a `parallel` layout that `world` processes (or
    one-process blocks) cannot hold (`parallel.mesh.check_layout`)."""
    check_layout(cfg.parallel, world)


class TrainStep:
    """A train step over `model`; see `make_train_step`.  Attributes:
    `optimizer`, `scheduler`, `params` (the model's parameter list),
    `ema` (None, or f32 tensors aligned with `params`), `graph_declines`
    (why no step runs as CUDA graphs; empty where they may), `graph_skips`
    ({signature: why its steps stay eager}), the counters
    `graph_captures`, `graph_replays` and `eager_steps`, and
    `graph_pool_bytes` (what the graphs' pool took from the device at its
    captures)."""

    graph_captures = 0
    graph_replays = 0
    eager_steps = 0
    graph_pool_bytes = 0

    def __init__(self, cfg: LECCRConfig, model: LECCRModel, total_steps: int,
                 num_blocks: int = 1, mesh: Optional[DataMesh] = None):
        tc, mc = cfg.train, cfg.model
        if mesh is not None:
            if num_blocks not in (1, mesh.data_world):
                raise ValueError(f"num_blocks {num_blocks} over a data axis "
                                 f"of {mesh.data_world}")
            num_blocks = mesh.data_world
            check_parallel(cfg, mesh.world)
            if mesh.model_world != cfg.parallel.model:
                raise ValueError(f"parallel.model: {cfg.parallel.model} on "
                                 f"a mesh of model {mesh.model_world}")
        else:
            check_parallel(cfg, num_blocks)
            if cfg.parallel.model > 1:
                raise ValueError(f"parallel.model: {cfg.parallel.model} runs "
                                 "over processes: pass a DataMesh")
        if mesh is not None and mesh.model_world > 1 and getattr(
                model, "tp_group", None) is None:
            shard_model(model, mesh)
        if cfg.parallel.fsdp and getattr(model, "fsdp", None) is None:
            group = (LocalDataGroup(num_blocks) if mesh is None else
                     ProcessDataGroup(mesh.data_rank, mesh.data_world,
                                      mesh.group))
            shard_fsdp(model, group, cfg.parallel.fsdp_min_size)
        negatives = cfg.parallel.negatives
        stream_rows = cfg.parallel.stream_loss_block_rows
        if negatives not in ("gather", "fused", "ring", "ring_fused"):
            raise ValueError(f"unknown negatives: {negatives!r}")
        if negatives == "ring" and stream_rows == 0:
            stream_rows = 256  # the JAX trainer's default (trainer.py:344-345)
        self.model, self.mc = model, mc
        self.mesh = mesh
        self.rank = mesh.data_rank if mesh is not None else 0
        self.num_blocks = num_blocks
        # the ring's block impl, where the ITC losses take the ring
        self.ring_impl = None
        if negatives in ("ring", "ring_fused") and (
                mesh is not None or num_blocks > 1):
            self.ring_impl = "fused" if negatives == "ring_fused" else "dense"
        # video: frames skip the image preprocessing, and the
        # caption-vision loss is a local (per-block) term
        self.is_video = mc.vision.kind == "temporal"
        self.stream_rows = stream_rows
        self.itc_loss_fn = infonce_loss if negatives == "fused" else None
        self.microbatches = tc.grad_cache_microbatches
        self.grad_clip = tc.grad_clip
        self.debug_nans = tc.debug_nans
        self.ema_decay = tc.ema_decay
        schedule = linear_warmup_decay(tc.optimizer.lr, total_steps,
                                       tc.schedular.num_warmup_steps)
        self.graph_declines = graph_declines(cfg, model.device, mesh,
                                             num_blocks)
        self.optimizer, self.scheduler = build_optimizer(
            tc.optimizer, model, schedule,
            lr_mult_paths=tuple(tc.optimizer.lr_mult_paths),
            frozen_paths=("clip_text_tower",),
            capturable=not self.graph_declines)
        capturable = self.optimizer.defaults.get("capturable", False)
        if not self.graph_declines and not capturable:
            self.graph_declines.append("legacy_eps or bf16 moments: the "
                                       "port's AdamW is not capturable")
        # held weakly: a cycle would keep a dropped step, its graphs and
        # their pool until the garbage collector runs
        after_load = weakref.WeakMethod(self._after_optimizer_load)

        def load_hook(optimizer):
            method = after_load()
            if method is not None:
                method(optimizer)

        self.optimizer.register_load_state_dict_post_hook(load_hook)
        self._graphs: Dict[tuple, StepGraphs] = {}
        self.graph_skips: Dict[tuple, str] = {}
        # {signature: its first eager step's peak above what stays live}
        self._peaks: Dict[tuple, int] = {}
        self._pool = None  # the graphs' memory pool, shared
        self._grads_of: Optional[StepGraphs] = None
        # where a capturable AdamW reads each group's learning rate
        self._lr: Optional[torch.Tensor] = None
        if capturable:
            self._lr = torch.zeros(len(self.optimizer.param_groups),
                                   dtype=torch.float32, device=model.device)
            self._graph_gen = torch.Generator(device=model.device)
            # one stream for every capture: the allocator hands a capture
            # the pool's free blocks only on the stream that freed them
            self._capture_stream = torch.cuda.Stream(model.device)
            # it runs eagerly too, on purpose: the same bits either way
            self.optimizer._warned_capturable_if_run_uncaptured = True
        self.params = list(model.parameters())
        # FSDP's shards over processes: their gradients arrive summed
        fsdp = getattr(model, "fsdp", None)
        self.data_sharded = ([] if fsdp is None or fsdp.group.local
                             else fsdp_params(model))
        self.data_group = fsdp.group if self.data_sharded else None
        ids = {id(p) for p in self.data_sharded}
        self.reduced = [p for p in self.params if id(p) not in ids]
        self.ema = self.ema_of_params() if self.ema_decay > 0 else None
        self.randaugment_n = (cfg.data.randaugment_n if cfg.data.randaugment
                              else 0)
        self.randaugment_m = cfg.data.randaugment_m
        self.seed = tc.seed + 17
        model.train()

    @property
    def ema(self) -> Optional[List[torch.Tensor]]:
        return self._ema

    @ema.setter
    def ema(self, value: Optional[List[torch.Tensor]]) -> None:
        self._ema = value
        if getattr(self, "_graphs", None):
            self._drop_graphs()  # their optimizer phase steps the old EMA

    def _drop_graphs(self) -> None:
        if self._graphs:
            torch.cuda.synchronize(self.model.device)
            self.optimizer.zero_grad(set_to_none=True)  # the pool's grads
        self._graphs.clear()
        self.graph_skips.clear()
        self._peaks.clear()
        self._pool, self._grads_of = None, None
        self.graph_pool_bytes = 0

    def _after_optimizer_load(self, optimizer) -> None:
        """After `optimizer.load_state_dict`: the groups take this step's
        capturable mode (a file written in the other mode holds that one),
        the step counts move where the mode keeps them (the device, or the
        host), and the graphs, which read the old state, are dropped."""
        if "capturable" in optimizer.defaults:
            capturable = optimizer.defaults["capturable"]
            for group in optimizer.param_groups:
                group["capturable"] = capturable
                for p in group["params"]:
                    state = optimizer.state.get(p, {})
                    if "step" in state:
                        state["step"] = (
                            state["step"].to(p.device, torch.float32)
                            if capturable else state["step"].to("cpu"))
        self._drop_graphs()

    @torch.no_grad()
    def ema_of_params(self) -> List[torch.Tensor]:
        """A fresh EMA: f32 copies of the parameters."""
        return [p.detach().to(torch.float32, copy=True) for p in self.params]

    def _itc_loss_fn(self, local: Optional[Dict[int, torch.Tensor]],
                     idx_local: torch.Tensor):
        """The ITC InfoNCE: the ring (over the mesh's processes, taking
        each gathered feature's local rows from `local`, or replayed over
        num_blocks), else `infonce_loss` for `fused`, else None (dense)."""
        impl, mesh = self.ring_impl, self.mesh
        if impl is None:
            return self.itc_loss_fn
        if mesh is None:
            return lambda a, b, t, i: ring_infonce(a, b, t, i,
                                                   self.num_blocks, impl)
        return lambda a, b, t, i: ring_infonce_local(
            local[id(a)], local[id(b)], t, idx_local, mesh, impl)

    def _world_batch(self, emb: TrainEmbeddings, idx: torch.Tensor):
        """(the data ranks' embeddings, their ids, {id(gathered feature):
        this rank's rows}): every per-row field all-gathered in data-rank
        order, the temperature with its cotangent divided by the data
        world."""
        mesh = self.mesh
        fields = {}
        for f in dataclasses.fields(TrainEmbeddings):
            value = getattr(emb, f.name)
            fields[f.name] = (scale_grad(value, 1.0 / mesh.data_world)
                              if f.name == "temp"
                              else all_gather_rows(value, mesh))
        local = {id(fields[n]): getattr(emb, n)
                 for n in ("image_feat", "text_feat_s", "text_feat_t")}
        return (TrainEmbeddings(**fields), all_gather_rows(idx, mesh),
                local)

    def objective(self, emb: TrainEmbeddings, idx: torch.Tensor):
        """(grad_total, the losses) of this rank's embeddings and ids."""
        local, idx_local = None, idx
        if self.mesh is not None:
            emb, idx, local = self._world_batch(emb, idx)
        b, mc = idx.shape[0], self.mc
        rows = self.stream_rows
        losses = compute_losses(
            emb, idx,
            weight_caption_loss=mc.weight_caption_loss,
            weight_reg_loss=mc.weight_reg_loss,
            weight_dstl_loss=mc.weight_dstl_loss,
            weight_cv_loss=mc.weight_cv_loss,
            dstl_alpha=mc.dstl_alpha,
            num_blocks=self.num_blocks,
            cv_loss_local=self.is_video,
            itc_loss_fn=self._itc_loss_fn(local, idx_local),
            stream_block_rows=(rows if 0 < rows < b and b % rows == 0
                               else 0))
        return (grad_total(losses, mc, self.num_blocks, self.is_video),
                losses)

    def _backward(self, batch: Dict[str, torch.Tensor], idx: torch.Tensor,
                  step_no: int) -> Dict[str, torch.Tensor]:
        model = self.model
        if self.microbatches > 1:
            gens = [microbatch_generators(self.seed, step_no, k, model.device,
                                          self.rank)
                    for k in range(self.microbatches)]
            return grad_cache_backward(
                model, batch, gens, lambda emb: self.objective(emb, idx),
                self.randaugment_n, self.randaugment_m)
        gens = step_generators(self.seed, step_no, model.device, self.rank)
        with span("train.forward"):
            emb = self._forward(batch, gens)
        with span("train.loss"):
            value, losses = self.objective(emb, idx)
        with span("train.backward"):
            value.backward()
        return losses

    def _forward(self, batch: Dict[str, torch.Tensor],
                 gens: Generators) -> TrainEmbeddings:
        """The forward phase of a step without GradCache: the images'
        preprocessing (which takes `flip` out of `batch`), the model."""
        if not self.is_video:
            batch["vision"] = preprocess_train_images(
                batch["vision"], batch.pop("flip", None), gens.aug,
                self.randaugment_n, self.randaugment_m)
        return self.model(batch, gens)

    def run(self, batch: Dict[str, torch.Tensor], step_no: int
            ) -> torch.Tensor:
        """One step; the losses as a fresh [len(LOSS_KEYS)] f32 tensor on
        the device, not read back (unless train.debug_nans).  Spans:
        `train.step` around the call, `train.forward`, `train.loss`,
        `train.backward` and `train.optimizer` inside it, and
        `train.graph` inside each of those where it replays a graph
        (`utils.tracing`)."""
        with span("train.step"):
            batch = dict(batch)
            idx = batch.pop("idx")
            key = (None if self.graph_declines
                   else self._signature(batch, idx))
            graphs = self._graphs_for(key, batch, idx)
            if graphs is not None:
                return self._replay(graphs, batch, idx, step_no)
            return self._eager(batch, idx, step_no, key)

    def _eager(self, batch: Dict[str, torch.Tensor], idx: torch.Tensor,
               step_no: int, key: Optional[tuple]) -> torch.Tensor:
        """`run`'s step without graphs.  The first step of a signature
        that graphs may take notes its peak memory above what stays live,
        and whether it launched a kernel that takes its dropout seed by
        value."""
        self.eager_steps += 1
        self.optimizer.zero_grad(set_to_none=True)
        self._grads_of = None
        first = key is not None and key not in self._peaks
        if first:
            device = self.model.device
            live = torch.cuda.memory_allocated(device)
            by_value = flash_tower_attention.by_value_seed_launches
        with nan_checks(self.debug_nans):
            losses = self._backward(batch, idx, step_no)
        with span("train.optimizer"):
            self._update(losses)
        if first:
            # an all-time peak bounds this step's from above
            self._peaks[key] = torch.cuda.max_memory_allocated(device) - live
            if flash_tower_attention.by_value_seed_launches != by_value:
                self.graph_skips[key] = ("kernels 4-8 with dropout on: they "
                                         "take their seed by value")
        return _loss_vector(losses)

    def _signature(self, batch: Dict[str, torch.Tensor],
                   idx: torch.Tensor) -> tuple:
        return (self.model.training, tuple(idx.shape), idx.dtype,
                tuple((k, tuple(v.shape), v.dtype)
                      for k, v in sorted(batch.items())))

    def _graphs_for(self, key: Optional[tuple],
                    batch: Dict[str, torch.Tensor],
                    idx: torch.Tensor) -> Optional[StepGraphs]:
        """The graphs that run this step, captured now if its signature's
        first step ran eagerly and the device has room (the module's
        docstring); None where it runs eagerly."""
        if key in self._graphs:
            return self._graphs[key]
        if key is None or key in self.graph_skips or key not in self._peaks:
            return None
        device = self.model.device
        # dropped graphs freed, and the eager steps' cached blocks back to
        # the device, for the pool to take (as torch.cuda.graph does)
        gc.collect()
        torch.cuda.empty_cache()
        # what is reserved and not allocated now lies in the pool, free for
        # the capture; it needs twice the eager step's peak at most (a
        # first capture's pool came to 1.16 times it: the flagship, bs128)
        slack = (torch.cuda.memory_reserved(device)
                 - torch.cuda.memory_allocated(device))
        growth = max(0, 2 * self._peaks[key] - slack)
        need = growth + max(self._peaks.values())
        free = torch.cuda.mem_get_info(device)[0]
        if free < need:
            self.graph_skips[key] = (f"{free} bytes free, {need} wanted: the "
                                     f"pool's growth and an eager step")
            return None
        graphs = self._graphs[key] = self._capture(batch, idx)
        return graphs

    def _capture(self, batch: Dict[str, torch.Tensor],
                 idx: torch.Tensor) -> StepGraphs:
        """The four phases of a step on copies of `batch` and `idx`,
        captured (not run) on a side stream into the shared pool."""
        device = self.model.device
        inputs = {k: v.clone() for k, v in batch.items()}
        static_idx = idx.clone()
        seeds = SeedSlots(device)
        # a replay reseeds the device stream and stages the seeds: what
        # this pass draws on the host is never used
        gens = Generators(self._graph_gen, torch.Generator(),
                          torch.Generator(), seeds)
        held = {}

        def forward():
            held["emb"] = self._forward(dict(inputs), gens)

        def loss():
            held["value"], held["losses"] = self.objective(held.pop("emb"),
                                                           static_idx)
            held["out"] = _loss_vector(held["losses"])

        def backward():
            held.pop("value").backward()

        def optimizer():
            self._apply_update(held.pop("losses"))

        self.optimizer.zero_grad(set_to_none=True)
        self._grads_of = None
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        reserved = torch.cuda.memory_reserved(device)
        stream = self._capture_stream
        stream.wait_stream(torch.cuda.current_stream(device))
        phases = []
        # a graph the collector destroyed mid-capture would end it
        collecting = gc.isenabled()
        gc.disable()
        try:
            with tracing.suspended(), torch.cuda.stream(stream):
                for name, fn in (("train.forward", forward),
                                 ("train.loss", loss),
                                 ("train.backward", backward),
                                 ("train.optimizer", optimizer)):
                    graph = torch.cuda.CUDAGraph()
                    if name == "train.forward":
                        graph.register_generator_state(self._graph_gen)
                    before = launch_counts()
                    graph.capture_begin(pool=self._pool,
                                        capture_error_mode="thread_local")
                    try:
                        fn()
                    finally:
                        graph.capture_end()
                    launched = {k: v - before.get(k, 0)
                                for k, v in launch_counts().items()
                                if v != before.get(k, 0)}
                    # a capture launches nothing: replays bring its counts
                    add_launch_counts({k: -v for k, v in launched.items()})
                    phases.append((name, graph, launched))
        finally:
            if collecting:
                gc.enable()
        torch.cuda.current_stream(device).wait_stream(stream)
        self.graph_captures += 1
        self.graph_pool_bytes += torch.cuda.memory_reserved(device) - reserved
        return StepGraphs(inputs, static_idx, seeds, phases, held["out"],
                          [p.grad for p in self.params])

    def _replay(self, g: StepGraphs, batch: Dict[str, torch.Tensor],
                idx: torch.Tensor, step_no: int) -> torch.Tensor:
        """Step `step_no` through `g`: the inputs, the seeds and the
        learning rates staged, each phase replayed inside its span, the
        launch counters advanced by what each capture launched."""
        gens = step_generators(self.seed, step_no, self.model.device,
                               self.rank)
        self._graph_gen.manual_seed(gens.device.initial_seed())
        for name, graph, launched in g.phases:
            with span(name):
                if name == "train.forward":
                    for k, v in batch.items():
                        g.inputs[k].copy_(v)
                    g.idx.copy_(idx)
                    g.seeds.stage([gens.flash_seed()
                                   for _ in range(g.seeds.taken)])
                elif name == "train.optimizer":
                    self._stage_lr()
                with span("train.graph"):
                    graph.replay()
                add_launch_counts(launched)
                if name == "train.optimizer":
                    self.scheduler.step()
        if self._grads_of is not g:
            for p, grad in zip(self.params, g.grads):
                p.grad = grad
            self._grads_of = g
        self.graph_replays += 1
        return g.out.clone()  # the caller may keep it past the next step

    def _stage_lr(self) -> None:
        """Each group's learning rate into the device tensor a capturable
        AdamW reads (a non-blocking copy from pinned memory)."""
        if self._lr is not None:
            lrs = [float(g["lr"]) for g in self.optimizer.param_groups]
            self._lr.copy_(torch.tensor(lrs, dtype=torch.float32)
                           .pin_memory(), non_blocking=True)

    def _optimizer_step(self) -> None:
        """optimizer.step(); a capturable AdamW reads its learning rates
        from the device tensor while it steps, so that a graph of the
        step reads each step's, and `param_groups` keep the floats."""
        if self._lr is None:
            self.optimizer.step()
            return
        groups = self.optimizer.param_groups
        lrs = [g["lr"] for g in groups]
        for i, g in enumerate(groups):
            g["lr"] = self._lr[i]
        try:
            self.optimizer.step()
        finally:
            for g, lr in zip(groups, lrs):
                g["lr"] = lr

    def _update(self, losses: Dict[str, torch.Tensor]) -> None:
        """After an eager backward: `_apply_update`, then the scheduler's
        step."""
        self._stage_lr()
        self._apply_update(losses)
        self.scheduler.step()

    def _apply_update(self, losses: Dict[str, torch.Tensor]) -> None:
        """After the backward: the gradient sums over a mesh, the checks of
        `train.debug_nans`, the clip, the optimizer step and the EMA."""
        for p in self.params:  # optax decays a param whose gradient is zero
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.mesh is not None:
            sum_column_bias_grads(self.model)
            all_reduce_grads(self.reduced, self.mesh)
        if self.debug_nans:
            assert_all_finite(losses, "losses")
            assert_all_finite([p.grad for p in self.params], "gradients")
        if self.grad_clip > 0.0:
            clip_by_global_norm(self.params, self.grad_clip,
                                sharded_params(self.model),
                                getattr(self.model, "tp_group", None),
                                self.data_sharded, self.data_group)
        self._optimizer_step()
        if self.ema is not None:
            ema_update_(self.ema, self.params, self.ema_decay)

    def __call__(self, batch: Dict[str, torch.Tensor], step_no: int
                 ) -> Dict[str, float]:
        return dict(zip(LOSS_KEYS, self.run(batch, step_no).tolist()))


def make_train_step(cfg: LECCRConfig, model: LECCRModel, total_steps: int,
                    num_blocks: int = 1,
                    mesh: Optional[DataMesh] = None) -> TrainStep:
    """A train step over `model` (put in training mode here), with the
    optimizer and scheduler of `cfg.train` for a run of `total_steps`
    optimizer steps; they are the returned step's `optimizer` and
    `scheduler` attributes, the EMA (train.ema_decay > 0) its `ema`.

    batch: "vision" uint8 [B,H,W,3] with "flip" bool [B] (optional), or
    for video "vision" f32 frames [B,T,Df] with "vision_mask" bool [B,T];
    "idx" [B],
    "text_ids_s"/"text_mask_s", "text_ids_t"/"text_mask_t", "caption_ids"/
    "caption_mask" (or "caption_feats"), all on the model's device; under
    a `mesh`, this rank's rows."""
    return TrainStep(cfg, model, total_steps, num_blocks, mesh)
