"""The training/eval engine (the port of `leccr_tpu/train/trainer.py`):
epoch loop with per-language retrieval eval, best-checkpoint gating, exact
mid-epoch resume, the EMA, JSONL logs; on one device or as one rank of a
data-parallel world.

    trainer = Trainer(cfg)           # on the GPU; Trainer(cfg, "cpu") for tests
    trainer = Trainer(cfg, mesh=DataMesh.from_env(cfg.parallel))  # a rank
    trainer.fit()                    # train, eval, checkpoint each epoch

- The train step is `train.step.TrainStep` (towers, interaction, the five
  losses, AdamW, the EMA); batches come from `data.pipeline.TrainLoader`
  through `device_prefetch`.  Losses stay on the device and are read back
  at `train.log_every` boundaries, all pending steps in one transfer.
- Evaluation embeds the split's texts back to back, then its image batches
  (decoded on a background thread, uploaded through `device_prefetch`),
  ranks on the device and computes Recall@K, on `eval_params`: with the
  EMA on (and `train.ema_eval`), a second model holding the EMA weights.
  Decoded image batches are kept on the device across epochs within
  `data.cache_eval_on_device_mb`: first-come whole-split admission, no
  eviction.
- Resume is exact: the epoch and the batch within it come from the step
  counter, and the scheduler from the optimizer's step count.
- Under a `mesh` (`parallel.mesh.DataMesh`, W = D data × M model
  processes): each data rank loads `batch_size_train / D` rows of each
  step (`TrainLoader`'s process shard; a model group reads the same rows)
  and the step sums the data ranks' gradients (`train.step`); the eval
  batches round up to a multiple of D, each data rank embeds its slice of
  each and the embeddings are all-gathered in global order, so every rank
  ranks the whole split and gets the single process's metrics.  Only rank
  0 prints, logs, writes checkpoints and mirrors to hdfs; then the ranks
  meet at a barrier.  `resume` loads on every rank.
- With M > 1 the model (and the EMA's eval model) is sharded over the
  model group (`parallel.tensor`); with `parallel.fsdp` over D > 1 data
  ranks, over the data group too (`parallel.fsdp`: each rank keeps its
  shard of every large parameter, of its Adam moments and of its EMA, and
  the train and eval models gather the weights at use; the eval ranks
  embed the replicated run's rows).  A checkpoint holds the dense state in
  the one-process format: the parameters, the Adam moments and the EMA
  gathered over the data group, then the model group (`gather_state`); a
  resume or an initial checkpoint loads the dense weights on every rank
  and takes the rank's slices, so a run resumes on another layout, with
  or without FSDP.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from leccr_torch.config import LECCRConfig
from leccr_torch.data.images import normalize_images
from leccr_torch.data.pipeline import (
    EvalLoader,
    TrainLoader,
    background_iter,
    device_prefetch,
)
from leccr_torch.data.tokenizers import make_tokenizers
from leccr_torch.device import resolve_device
from leccr_torch.eval.retrieval import itm_metrics_from_ranks, retrieval_ranks
from leccr_torch.models.leccr import LECCRModel
from leccr_torch.models.losses import LOSS_KEYS as STEP_LOSS_KEYS
from leccr_torch.parallel.fsdp import shard_fsdp
from leccr_torch.parallel.mesh import DataMesh, all_gather_rows
from leccr_torch.parallel.tensor import (
    gather_optimizer_state,
    gather_state,
    gather_tensors,
    is_sharded,
    load_dense_state,
    shard_model,
    shard_optimizer_state,
    shard_tensors,
)
from leccr_torch.train.checkpoints import CheckpointManager
from leccr_torch.train.metrics import JSONLLogger, MetricLogger, SmoothedValue
from leccr_torch.train.schedule import linear_warmup_decay
from leccr_torch.train.step import TrainStep, check_parallel

LOSS_KEYS = ("loss_itc_vs", "loss_itc_vt", "loss_itc_st", "loss_itc_c",
             "loss_reg_c")
_LOSS_INDEX = [STEP_LOSS_KEYS.index(k) for k in LOSS_KEYS]


def build_datasets(cfg: LECCRConfig, rank: int = 0):
    """(train_ds, {lang: val_ds}, {lang: test_ds}) in the reference layout
    (dataset/__init__.py:117-162): image datasets, or with `dataset: video`
    the feature-bank video datasets at `model.vision.max_frames`.
    `dataset: synthetic` writes a tiny Multi30K-layout set under
    `<output_dir>/.synthetic` first (rank r > 0 of a data-parallel world:
    the same set, from the same seed, under `.synthetic.rank<r>`, so no
    two processes write one file) and points `cfg.data` at it."""
    from leccr_torch.data.datasets import (
        ImageEvalDataset,
        ImageTrainDataset,
        VideoEvalDataset,
        VideoTrainDataset,
    )

    data = cfg.data
    if data.dataset == "video":
        frames = cfg.model.vision.max_frames
        return (VideoTrainDataset(data, frames),
                {k: VideoEvalDataset(data, p, frames, "eval")
                 for k, p in data.val_file.items()},
                {k: VideoEvalDataset(data, p, frames, "test")
                 for k, p in data.test_file.items()})
    if data.dataset == "synthetic":
        from leccr_torch.data.synthetic import make_image_dataset

        root = Path(cfg.output_dir) / (
            ".synthetic" + (f".rank{rank}" if rank else ""))
        synth = make_image_dataset(
            str(root), n_train=data.synthetic_size,
            n_eval=data.synthetic_eval_images,
            caps_per_image=data.synthetic_captions_per_image,
            image_res=cfg.model.vision.image_res, seed=data.seed,
            learnable=data.synthetic_learnable)
        for field in ("root_dir", "train_file", "val_file", "test_file",
                      "image_root", "generated_caption_dir", "text_vocab"):
            setattr(data, field, getattr(synth, field))
        data.dataset = "multi30k"
        if cfg.model.text.kind == "xlmr":
            # the xlmr tower pairs with the Unigram tokenizer: a tiny
            # unigram vocab over the synthetic words
            from leccr_torch.data.synthetic import _WORDS_EN, _WORDS_T
            from leccr_torch.data.tokenizers import write_tiny_unigram_vocab

            uni = str(Path(synth.root_dir) / "unigram.tsv")
            write_tiny_unigram_vocab(uni, _WORDS_EN + _WORDS_T)
            data.text_vocab = uni
    res = cfg.model.vision.image_res
    train = ImageTrainDataset(data, res)
    val = {k: ImageEvalDataset(data, p, res, "eval")
           for k, p in data.val_file.items()}
    test = {k: ImageEvalDataset(data, p, res, "test")
            for k, p in data.test_file.items()}
    return train, val, test


@dataclasses.dataclass
class TrainState:
    """The trained state: the model's parameters and the step's optimizer,
    scheduler and EMA (`train_step`), and the count of steps taken."""

    model: LECCRModel
    train_step: TrainStep
    step: int = 0

    @property
    def optimizer(self) -> torch.optim.Optimizer:
        return self.train_step.optimizer

    @property
    def ema(self) -> Optional[List[torch.Tensor]]:
        """The EMA of the parameters (train.ema_decay > 0), else None."""
        return self.train_step.ema


class Trainer:
    def __init__(self, cfg: LECCRConfig,
                 device: Optional[Union[str, torch.device]] = None,
                 mesh: Optional[DataMesh] = None):
        """device: None = the GPU (raises when there is none); the tests
        pass "cpu".  mesh: this process's place in a data-parallel world
        (its device is the mesh's)."""
        self.cfg = cfg
        self.mesh = mesh
        if mesh is not None:
            mesh.use_layout(cfg.parallel)
        # the data axis: the loaders' shards and the eval's row split
        self.world = mesh.data_world if mesh is not None else 1
        self.rank = mesh.data_rank if mesh is not None else 0
        self.is_main = mesh is None or mesh.is_main
        self.device = (mesh.device if mesh is not None
                       else resolve_device(device))
        self.is_video = cfg.model.vision.kind == "temporal"
        check_parallel(cfg, mesh.world if mesh is not None else 1)
        # eval batches split over the ranks: sizes round up to a multiple
        # of the world (trainer.py:203-207)
        w = self.world
        cfg.train.batch_size_test = -(-cfg.train.batch_size_test // w) * w
        cfg.train.batch_size_test_text = (
            -(-cfg.train.batch_size_test_text // w) * w)
        self.train_ds, self.val_ds, self.test_ds = build_datasets(
            cfg, mesh.rank if mesh is not None else 0)
        # startup summary (reference image_Retrieval_caption.py:345-349)
        self.print(f"### Train Files: "
                   f"{[os.path.basename(p) for p in cfg.data.train_file]}")
        self.print(f"### Train data {len(self.train_ds)}, batch size "
                   f"{cfg.train.batch_size_train}, device {self.device}"
                   + ("" if mesh is None else f", {w} ranks"
                      if mesh.model_world == 1 else
                      f", {w} data × {mesh.model_world} model ranks"))
        self.print(f"### Validation: "
                   f"{[(k, len(d)) for k, d in self.val_ds.items()]}")
        self.print(f"### Test: "
                   f"{[(k, len(d)) for k, d in self.test_ds.items()]}")

        self.tokenizer, self.caption_tokenizer = make_tokenizers(cfg)
        self.train_loader = TrainLoader(
            self.train_ds, self.tokenizer, cfg.data,
            batch_size=cfg.train.batch_size_train,
            num_workers=cfg.data.num_workers,
            caption_tokenizer=self.caption_tokenizer,
            process_count=w, process_index=self.rank)
        self.print(f"### Tokenizer: {type(self.tokenizer).__name__} "
              f"({'native' if self.train_loader.native else 'Python'}), "
              f"captions: {type(self.caption_tokenizer).__name__}")
        self.steps_per_epoch = self.train_loader.steps_per_epoch()
        total_steps = max(1, cfg.train.schedular.epochs
                          * self.steps_per_epoch)
        self.schedule = linear_warmup_decay(
            cfg.train.optimizer.lr, total_steps,
            cfg.train.schedular.num_warmup_steps)

        model = LECCRModel(cfg.model, device=self.device,
                           seed=cfg.train.seed)
        self.print(f"### Total Params: "
                   f"{sum(p.numel() for p in model.parameters())}")
        self.state = TrainState(model, TrainStep(cfg, model, total_steps,
                                                 mesh=mesh))
        self._ema_model: Optional[LECCRModel] = None
        # id(dataset) -> (dataset, [(device batch, count), ...]); the
        # dataset reference pins the id against reuse.  First-come
        # admission, no eviction (config.py cache_eval_on_device_mb)
        self._eval_device_cache: Dict[int, tuple] = {}
        self._eval_cache_bytes = 0
        self._hdfs_sync_state: dict = {}
        self.ckpt = CheckpointManager(cfg.output_dir,
                                      cfg.train.keep_checkpoints)
        self.logger = JSONLLogger(cfg.output_dir, enabled=self.is_main)
        # per train_epoch: {"epoch", "wait_s", "step_s"}, a list each
        # (host clock, per step: the time blocked on its batch, and from
        # asking for its batch to asking for the next, or to the epoch's
        # end after the last loss read-back)
        self.timing: List[Dict[str, Any]] = []

    def print(self, *args, **kwargs) -> None:
        """print on rank 0; the other ranks stay quiet."""
        if self.is_main:
            print(*args, **kwargs)

    def barrier(self) -> None:
        if self.mesh is not None:
            self.mesh.barrier()

    def load_initial_checkpoint(self, path: str):
        """Load initial weights (`models.weights.load_initial_checkpoint`:
        reference, OpenAI CLIP, HF BERT/XLM-R or the port's own) into the
        model's f32 parameters; the optimizer state stays fresh, and an
        EMA restarts from the loaded weights.  Returns the ImportReport."""
        from leccr_torch.models.weights import load_initial_checkpoint

        model = self.state.model
        if not is_sharded(model):
            report = load_initial_checkpoint(path, model)
        else:  # into the dense model, then each rank's slices
            dense = LECCRModel(self.cfg.model, device=self.device)
            dense.load_state_dict(gather_state(model))
            report = load_initial_checkpoint(path, dense)
            load_dense_state(model, dense.state_dict())
            del dense
        train_step = self.state.train_step
        if train_step.ema is not None:
            train_step.ema = train_step.ema_of_params()
        return report

    # ----------------------------------------------------------- epochs

    def _save(self, epoch: int, **kwargs) -> None:
        """Rank 0 writes the checkpoint (the dense state, gathered over the
        data and model groups); every rank then meets the others."""
        state = self.state
        model = state.model
        model_state = gather_state(model)
        opt_state = gather_optimizer_state(model, state.optimizer)
        ema = state.ema
        if ema is not None:
            names = [n for n, _ in model.named_parameters()]
            ema = list(gather_tensors(model, dict(zip(names, ema))).values())
        if not self.is_main:
            self.barrier()
            return
        self.ckpt.save(state.step, model_state, opt_state, epoch,
                       steps_per_epoch=self.steps_per_epoch, ema=ema,
                       **kwargs)
        self.barrier()

    def train_epoch(self, epoch: int, skip_steps: int = 0) -> Dict[str, str]:
        logger = MetricLogger(print_fn=self.print)
        logger.add_meter("lr", SmoothedValue(1, "{value:.6f}"))
        for key in LOSS_KEYS:
            logger.add_meter(key, SmoothedValue(1, "{value:.4f}"))
        header = f"Train Epoch: [{epoch}]"
        # device losses are read back only at print boundaries, all
        # pending steps in one transfer, so logging never stalls the card
        pending: List[Tuple[int, torch.Tensor]] = []

        def drain():
            if not pending:
                return
            fetched = torch.stack([v for _, v in pending]).tolist()
            for (step_no, _), row in zip(pending, fetched):
                logger.update(lr=self.schedule(step_no),
                              **{k: row[i] for k, i in zip(LOSS_KEYS,
                                                           _LOSS_INDEX)})
            pending.clear()

        log_every = self.cfg.train.log_every
        every = self.cfg.train.checkpoint_every_steps
        waits, starts = [], []
        batches = device_prefetch(
            self.train_loader.epoch(epoch, start_step=skip_steps),
            self.device)

        def timed():
            """The batches; the host clock when each was asked for, and
            how long the ask blocked."""
            while True:
                starts.append(time.perf_counter())
                batch = next(batches, None)
                if batch is None:
                    starts.pop()
                    return
                waits.append(time.perf_counter() - starts[-1])
                yield batch

        try:
            for i, batch in enumerate(logger.log_every(
                    timed(), log_every, header,
                    total=self.steps_per_epoch - skip_steps)):
                values = self.state.train_step.run(batch, self.state.step)
                self.state.step += 1
                pending.append((self.state.step, values))
                if i % log_every == 0:
                    # drained before the logger's post-yield print, so the
                    # printed meters hold this step's losses
                    drain()
                if (every > 0 and self.state.step % every == 0
                        and self.state.step % self.steps_per_epoch != 0):
                    # preemption-safe mid-epoch snapshot; the epoch's last
                    # step is fit()'s to save
                    self._save(epoch)
            drain()
        finally:
            batches.close()
        ends = starts[1:] + [time.perf_counter()]
        self.timing.append({"epoch": epoch, "wait_s": waits, "step_s": [
            end - start for start, end in zip(starts, ends)]})
        self.print("Averaged stats:", logger)
        return {k: f"{m.global_avg:.5f}" for k, m in logger.meters.items()}

    # ------------------------------------------------------------- eval

    @property
    def eval_params(self) -> List[torch.Tensor]:
        """The weights evaluate() runs on, aligned with the model's
        parameters: the EMA when it is on (train.ema_decay > 0 and
        ema_eval), else the trained parameters, so the per-epoch metrics
        and the best-checkpoint gating agree on which weights are 'the
        model'."""
        ema = self.state.ema
        if ema is not None and self.cfg.train.ema_eval:
            return ema
        return list(self.state.model.parameters())

    def eval_model(self) -> LECCRModel:
        """A model holding `eval_params`: the trained model itself, or a
        second model the EMA is copied into (the trained model's
        parameters are never swapped)."""
        if self.eval_params is not self.state.ema:
            return self.state.model
        if self._ema_model is None:
            self._ema_model = LECCRModel(self.cfg.model, device=self.device)
            trained = self.state.model
            if getattr(trained, "tp_group", None) is not None:
                shard_model(self._ema_model, self.mesh)
            if getattr(trained, "fsdp", None) is not None:
                shard_fsdp(self._ema_model, trained.fsdp.group,
                           trained.fsdp.min_size)
        with torch.no_grad():
            torch._foreach_copy_(list(self._ema_model.parameters()),
                                 self.state.ema)
        return self._ema_model

    def _image_batches(self, loader: EvalLoader, dataset):
        """The split's image batches on the device: from the eval cache,
        or decoded on a background thread and uploaded (then admitted to
        the cache if the budget allows)."""
        entry = self._eval_device_cache.get(id(dataset))
        if entry is not None and entry[0] is dataset:
            yield from entry[1]
            return
        budget = self.cfg.data.cache_eval_on_device_mb * 2 ** 20
        collected = [] if budget > 0 else None
        for batch, count in device_prefetch(
                background_iter(loader.image_batches()), self.device):
            if collected is not None:
                collected.append((batch, count))
            yield batch, count
        if collected is not None:
            nbytes = sum(v.numel() * v.element_size()
                         for b, _ in collected for v in b.values())
            if self._eval_cache_bytes + nbytes <= budget:
                self._eval_device_cache[id(dataset)] = (dataset, collected)
                self._eval_cache_bytes += nbytes

    def embed_split(self, dataset):
        """(image feats [N_img, E], image slots [N_img, n, E], text embeds
        [N_txt, E]) of one eval split, on the device."""
        cfg = self.cfg
        loader = EvalLoader(
            dataset, self.tokenizer, cfg.data,
            batch_size=cfg.train.batch_size_test,
            text_batch_size=cfg.train.batch_size_test_text,
            caption_tokenizer=self.caption_tokenizer,
            num_workers=cfg.data.num_workers,
            process_count=self.world, process_index=self.rank)
        model = self.eval_model()
        # texts are pre-tokenized: one upload, then every batch back to
        # back with no host sync; only the last batch holds pad rows
        tb = list(loader.text_batches())
        ids = torch.from_numpy(np.stack([t[0] for t in tb])).to(self.device)
        mask = torch.from_numpy(np.stack([t[1] for t in tb])).to(self.device)
        n_txt = sum(t[2] for t in tb)
        text_embeds = self._global_rows(torch.stack(
            [model.embed_texts(ids[i], mask[i]) for i in range(len(tb))]),
            n_txt)
        feats, slots, n_img = [], [], 0
        for batch, count in self._image_batches(loader, dataset):
            if not self.is_video:  # video frames go in as they are
                batch = {**batch, "vision": normalize_images(batch["vision"])}
            out = model.embed_images(batch)
            feats.append(out["feat"])
            slots.append(out["slots"])
            n_img += count
        return (self._global_rows(torch.stack(feats), n_img),
                self._global_rows(torch.stack(slots), n_img), text_embeds)

    def _global_rows(self, local: torch.Tensor, n: int) -> torch.Tensor:
        """The split's first n rows from per-batch local rows [nb, b, ...]:
        every rank's slice of each batch in rank order (the global batch),
        batches in order, padding rows (at the split's end) dropped."""
        lead = 2
        if self.world > 1:  # [W, nb, b, ...] -> [nb, W, b, ...]
            local = all_gather_rows(local[None], self.mesh).transpose(0, 1)
            lead = 3
        return local.reshape(-1, *local.shape[lead:])[:n]

    def evaluate(self, dataset) -> Dict[str, float]:
        """Full retrieval eval of one split: embed texts and images (with
        the caption branch), streaming ranks on the device, Recall@K
        (reference evaluation_coarse → itm_eval)."""
        t0 = time.time()
        img_feats, img_slots, text_embeds = self.embed_split(dataset)
        fusion = self.cfg.train.eval_fusion
        if fusion == "auto":  # video: the double-sim; images: plain cosine
            fusion = "minmax" if self.is_video else "none"
        i2t, t2i = retrieval_ranks(
            img_feats, text_embeds, dataset.index.txt2img,
            dataset.index.img2txt,
            slots=img_slots if fusion != "none" else None,
            fusion=fusion, alpha=self.cfg.train.eval_alpha)
        metrics = itm_metrics_from_ranks(i2t, t2i)
        dt = str(datetime.timedelta(seconds=int(time.time() - t0)))
        self.print(f"Evaluation time {dt}")
        return metrics

    # --------------------------------------------------------------- fit

    def resume(self) -> Tuple[int, int]:
        """Restore the newest checkpoint of `output_dir`: the model, the
        optimizer, the step counter, the scheduler and the EMA.  Returns
        (epoch, batches of it already taken) to continue from.

        The epoch and the batch within it come from the step counter (the
        per-epoch permutation is deterministic), so a mid-epoch snapshot
        resumes at its batch.  When steps_per_epoch changed since the
        save, the position is void: a warning, and training restarts at
        the next epoch boundary.  An EMA is seeded from the restored
        parameters when the checkpoint has none, and a stored EMA is
        dropped when the EMA is off."""
        model_state, opt_state, ema, meta = self.ckpt.restore()
        state = self.state
        load_dense_state(state.model, model_state)
        state.optimizer.load_state_dict(shard_optimizer_state(
            state.model, state.optimizer, opt_state))
        if ema is not None:  # the rank's slices of a dense EMA
            names = [n for n, _ in state.model.named_parameters()]
            ema = list(shard_tensors(state.model,
                                     dict(zip(names, ema))).values())
        step = int(meta["step"])
        train_step = state.train_step
        # the schedule is a function of the optimizer's step count
        train_step.scheduler.last_epoch = step
        for group in state.optimizer.param_groups:
            group["lr"] = group["initial_lr"] * self.schedule(step)
        train_step.scheduler._last_lr = [
            g["lr"] for g in state.optimizer.param_groups]
        if self.cfg.train.ema_decay > 0:
            train_step.ema = (train_step.ema_of_params() if ema is None
                              else [t.to(self.device) for t in ema])
        else:
            train_step.ema = None
        state.step = step
        epoch, skip = divmod(step, self.steps_per_epoch)
        meta_epoch = int(meta["epoch"])
        meta_spe = int(meta["steps_per_epoch"])
        if (meta_spe and meta_spe != self.steps_per_epoch) or (
                not meta_spe and epoch not in (meta_epoch, meta_epoch + 1)):
            self.print("### WARNING: steps_per_epoch changed since the "
                       "checkpoint; restarting from the next epoch boundary "
                       "instead of the exact batch")
            epoch, skip = meta_epoch + 1, 0
            state.step = epoch * self.steps_per_epoch
        self.print(f"### resumed from step {step}, epoch {epoch}"
                   + (f" (skipping {skip} consumed batches)" if skip else ""))
        return epoch, skip

    def fit(self, evaluate_only: bool = False) -> Dict[str, Any]:
        cfg = self.cfg
        start_epoch = resume_skip = 0
        best, best_epoch = 0.0, 0
        if cfg.train.resume and self.ckpt.latest_step() is not None:
            start_epoch, resume_skip = self.resume()
            info = self.ckpt.best_info()
            if info:
                best = info.get("metrics", {}).get("sumr_sum", 0.0)
                best_epoch = info.get("epoch", 0)

        max_epoch = cfg.train.schedular.epochs
        last_stats: Dict[str, Any] = {}
        for epoch in range(start_epoch, max_epoch):
            log_stats: Dict[str, Any] = {"epoch": epoch}
            if not evaluate_only:
                skip = resume_skip if epoch == start_epoch else 0
                train_stats = self.train_epoch(epoch, skip_steps=skip)
                log_stats.update(
                    {f"train_{k}": v for k, v in train_stats.items()})

            sumr_sum = 0.0
            for language in self.val_ds:
                val_result = self.evaluate(self.val_ds[language])
                test_result = self.evaluate(self.test_ds[language])
                self.print(f"{language}-val: {val_result}")
                self.print(f"{language}-test: {test_result}")
                sumr_sum += test_result["sumr_sum"]
                log_stats.update(
                    {f"{language}_val_{k}": v for k, v in val_result.items()})
                log_stats.update(
                    {f"{language}_test_{k}": v
                     for k, v in test_result.items()})
            last_stats = log_stats
            self.logger.write(log_stats)
            if evaluate_only:
                break

            is_best = sumr_sum > best
            every_ep = cfg.train.checkpoint_every_epochs
            periodic = every_ep > 0 and (epoch + 1) % every_ep == 0
            if is_best or periodic or epoch >= max_epoch - 1:
                self._save(epoch, config_json=cfg.to_json(),
                           metrics={"sumr_sum": sumr_sum}, is_best=is_best)
            if is_best:
                best, best_epoch = sumr_sum, epoch
            self.print(f"best epoch is {best_epoch} and best sumr is "
                       f"{best:.2f}")
            if cfg.remote_output_dir and self.is_main:
                # mirror the output dir (checkpoints, log.txt, config.json)
                # once the save has landed (reference utils/checkpointer.py
                # :20-46 uploads per epoch)
                self.ckpt.wait()
                self._sync_outputs()
        self.ckpt.wait()
        self.logger.write({"best_epoch": best_epoch, "best": best})
        if self.is_main:
            self._sync_outputs()
        self.barrier()  # the checkpoints are on disk for every rank
        return last_stats

    def _sync_outputs(self) -> None:
        if self.cfg.remote_output_dir:
            from leccr_torch.utils import io as lio

            # the (size, mtime) manifest makes the syncs incremental: a
            # multi-GB best checkpoint uploads once, not every epoch
            lio.sync_dir_to_remote(self.cfg.output_dir,
                                   self.cfg.remote_output_dir,
                                   state=self._hdfs_sync_state)
