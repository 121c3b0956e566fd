"""Traffic of kind "train": `TrainStep.run(batch, step_no)` over a pool of
batches drawn in turn.

The mix gives the pool's size ("pool"), the real text lengths ("text_tokens":
a list of [low, high] ranges, one per pool batch in turn), the caption
lengths ("caption_tokens"), the share of flipped images ("flip_share"),
the warm-up steps, the steps the reference follows ("compared_steps") and
the traced slice ("trace_steps", "trace_at").  Texts are padded to the
smallest of the configuration's token buckets that holds the batch's
longest source or target text, captions likewise, both clamped to the
largest bucket (the program's training loader, `data.pipeline`); images
are uint8 at the configuration's resolution.

What is compared (`compare_train`): the total loss of the first steps and
of one step taken after the window through the same call, from the
program's own weights there; each leaf's first gradient and its change
after the first steps; each leaf's weight decay and learning rate in the
program's optimizer against the configuration's rule and schedule.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import drivers, generator
from benchmark.reference.model import Precision
from benchmark.reference.train import (
    LOSS_KEYS,
    change_gap,
    leaf_decay,
    leaf_gap,
    negligible,
    norms,
    reference_loss,
    reference_steps,
    settings,
)
from benchmark.tracing import Slice
from benchmark.weights import stream_seed

TEST_SIZE = {"pool": 4}


def inputs(mix: dict, cfg, seed: int, device) -> List[Dict[str, torch.Tensor]]:
    """The mix's pool of training batches, as `TrainStep.run` takes them."""
    b = cfg.train.batch_size_train
    vocab = cfg.model.text.vocab_size
    buckets = cfg.data.token_buckets
    host = np.random.default_rng(stream_seed(seed, 2))
    g = torch.Generator(device=device).manual_seed(stream_seed(seed, 3))
    pool = []
    ranges = mix["text_tokens"]
    for j in range(mix["pool"]):
        span = ranges[j % len(ranges)]
        len_s = generator.lengths(host, span, b)
        len_t = generator.lengths(host, span, b)
        len_c = generator.lengths(host, mix["caption_tokens"], b)
        width = generator.bucket_width(np.concatenate([len_s, len_t]),
                                       buckets)
        batch = {
            "vision": generator.images(g, b, cfg.model.vision.image_res,
                                       device),
            "flip": torch.rand(b, generator=g, device=device)
            < mix["flip_share"],
            "idx": torch.arange(j * b, (j + 1) * b, device=device),
        }
        for key, lens, w in (
                ("text_ids_s", len_s, width), ("text_ids_t", len_t, width),
                ("caption_ids", len_c,
                 generator.bucket_width(len_c, buckets))):
            ids, mask = generator.tokens(g, lens, w, vocab, device)
            batch[key] = ids
            batch[key.replace("ids", "mask")] = mask
        pool.append(batch)
    return pool


class Driver(drivers.Driver):
    program_state = ("model", "step")

    def setup(self) -> None:
        from leccr_torch.train.step import make_train_step

        self.model = self._model()
        self.step = make_train_step(self.cfg, self.model,
                                    self.meta["schedule_steps"])
        self.pool = inputs(self.mix, self.cfg, self.seed, self.device)
        self.compared = self.mix["compared_steps"]
        self.losses: List[torch.Tensor] = []
        for k in range(max(self.mix["warmup_steps"], self.compared)):
            self.losses.append(self.step.run(self.pool[k % len(self.pool)], k))
            if k == 0:
                self.grad_norms = self._first_gradients()
            if k == self.compared - 1:
                self.sync()
                self.changes = self._changes()
            self.beat()
        self.sync()
        self.losses = [t.cpu() for t in self.losses[:self.compared]]
        self.next_step = max(self.mix["warmup_steps"], self.compared)

    def _first_gradients(self) -> Dict[str, float]:
        """‖g‖ of each parameter's first gradient, from its Adam first
        moment after one step (m = (1 − β₁) g); 0 where the step left no
        moment."""
        opt = self.step.optimizer
        out = {}
        for group in opt.param_groups:
            b1 = group["betas"][0]
            for p in group["params"]:
                state = opt.state.get(p, {})
                m = state.get("exp_avg", state.get("mu"))
                out[id(p)] = (torch.zeros_like(p) if m is None
                              else m.float() / (1.0 - b1))
        return norms({n: out.get(id(p), torch.zeros_like(p))
                      for n, p in self.model.named_parameters()})

    def _changes(self) -> Dict[str, torch.Tensor]:
        """Each parameter's change P − P0 so far, kept on the host."""
        w0 = self._weights()
        return {n: (p.detach() - w0[n]).to("cpu", non_blocking=False)
                for n, p in self.model.named_parameters()}

    def _groups(self) -> Dict[str, tuple]:
        """{parameter name: (weight decay, learning rate)} as the program's
        optimizer holds them now; None for a parameter in no group."""
        held = {id(p): (float(g["weight_decay"]), float(g["lr"]))
                for g in self.step.optimizer.param_groups
                for p in g["params"]}
        return {n: held.get(id(p)) for n, p in self.model.named_parameters()}

    def window(self, seconds: float, traced: bool) -> dict:
        pool, b = self.pool, self.cfg.train.batch_size_train
        trace_at = seconds * self.mix.get("trace_at", 0.3)
        enqueue: List[float] = []
        i, n, done_trace = self.next_step, 0, not traced
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            if not done_trace and time.perf_counter() - t0 >= trace_at:
                widths = []
                with Slice() as sl:
                    before = drivers.counters()
                    for _ in range(self.mix["trace_steps"]):
                        widths.append(self._widths(pool[i % len(pool)]))
                        last = self.step.run(pool[i % len(pool)], i)
                        i, n = i + 1, n + 1
                    launches = drivers.diff(drivers.counters(), before)
                with Slice(host=True) as named:
                    last = self.step.run(pool[i % len(pool)], i)
                    i, n = i + 1, n + 1
                self.trace = drivers.traced(sl, named, widths=widths,
                                            launches=launches)
                done_trace = True
                self.beat()
                continue
            ts = time.perf_counter()
            last = self.step.run(pool[i % len(pool)], i)
            enqueue.append(time.perf_counter() - ts)
            i, n = i + 1, n + 1
            self.beat()
        self.sync()
        t1 = time.perf_counter()
        self.next_step = i
        self.last_losses = last.cpu()
        self.attempted = n
        self.failed = int(not torch.isfinite(self.last_losses).all())
        self.enqueue_s = enqueue
        return {"train_pairs_per_s": n * b / (t1 - t0)}

    def after_window(self) -> None:
        """One more step through the window's call, from the program's
        state where the window left it: its weights before the step and
        its losses are kept for the reference, and the optimizer's groups
        after it."""
        k = self.next_step
        batch = self.pool[k % len(self.pool)]
        with torch.no_grad():
            weights = {n: p.detach().clone()
                       for n, p in self.model.named_parameters()}
        self.late = {"weights": weights, "batch": batch, "step": k,
                     "losses": self.step.run(batch, k).cpu()}
        self.groups = self._groups()
        self.beat()

    @staticmethod
    def _widths(batch) -> dict:
        return {"text": batch["text_ids_s"].shape[1],
                "caption": batch["caption_ids"].shape[1],
                "batch": batch["text_ids_s"].shape[0]}

    def _reference(self, prec=None):
        config, late = self.meta["config"], self.late
        ref = reference_steps(self._weights(), config,
                              self.pool[:self.compared],
                              list(range(self.compared)),
                              self.meta["schedule_steps"], prec)
        ref["late"] = reference_loss(late["weights"], config, late["batch"],
                                     late["step"], prec)
        return ref

    def check(self) -> Dict[str, tuple]:
        """{number: (value, where)} of the comparison with the reference."""
        ref = self._reference()
        return compare_train(
            self.losses + [self.late["losses"]],
            ref["losses"] + [ref["late"]], self.grad_norms, self.changes,
            ref, optimizer_mismatches(self.groups, self.meta["config"],
                                      self.meta["schedule_steps"],
                                      self.late["step"] + 1))

    def readings(self, control: bool) -> dict:
        """The program's numbers (and the whole leaves' parameter change,
        every element counted), and the fp8 control's in its place."""
        self.after_window()
        self.release()
        ref = self._reference()
        mism = optimizer_mismatches(self.groups, self.meta["config"],
                                    self.meta["schedule_steps"],
                                    self.late["step"] + 1)
        out = {"program": drivers.values(compare_train(
            self.losses + [self.late["losses"]],
            ref["losses"] + [ref["late"]], self.grad_norms, self.changes,
            ref, mism))}
        out["program"]["change_gap_whole_leaves"] = leaf_gap(
            norms(self.changes), norms(ref["change"]),
            negligible(ref["grad_norms"]))[0]
        if control:
            ctl = self._reference(Precision(fp8=True))
            out["control"] = drivers.values(compare_train(
                ctl["losses"] + [ctl["late"]],
                ref["losses"] + [ref["late"]], ctl["grad_norms"],
                ctl["change"], ref, 0.0))
        return out


def optimizer_mismatches(groups: Dict[str, tuple], config: dict,
                         total_steps: int, step_no: int) -> float:
    """The leaves whose weight decay, or learning rate for optimizer step
    `step_no`, in the program's optimizer differs from the
    configuration's rule (no decay for biases and LayerNorm scales) and
    schedule; a leaf in no group counts."""
    lr = settings(config, total_steps)["lr_at"](step_no)
    bad = 0
    for name, held in groups.items():
        if held is None:
            bad += 1
            continue
        wd, got_lr = held
        bad += int(wd != leaf_decay(name, config)
                   or abs(got_lr - lr) > 1e-9 * max(abs(lr), 1e-30))
    return float(bad)


def compare_train(losses, ref_losses, grad_norms, changes, ref,
                  mismatches: float) -> Dict[str, tuple]:
    """The train cell's numbers: the total loss of each compared step
    (relative gap; the last is the step after the window), each leaf's
    first gradient norm and each leaf's change after the first steps
    (worst leaf, against the larger of its own reference norm and the
    median leaf's), the leaves whose reference gradient is under a
    thousandth of the median leaf's left out; the optimizer's leaves off
    the configuration's rule or schedule."""
    total = LOSS_KEYS.index("total")
    gaps = [abs(float(p[total]) - float(r[total])) / abs(float(r[total]))
            for p, r in zip(losses, ref_losses)]
    worst = int(np.argmax(gaps))
    skip = negligible(ref["grad_norms"])
    grad_gap, grad_leaf = leaf_gap(grad_norms, ref["grad_norms"], skip)
    moved, moved_leaf = change_gap(changes, ref, skip)
    which = ("the step after the window" if worst == len(gaps) - 1
             else f"step {worst}")
    return {"loss_gap": (max(gaps), f"total loss, worst step: {which}"),
            "grad_gap": (grad_gap, f"first gradient norm, worst leaf "
                                   f"{grad_leaf}"),
            "change_gap": (moved, f"parameter change norm, worst leaf "
                                  f"{moved_leaf}"),
            "optimizer_mismatches": (mismatches, "leaves whose weight decay "
                                                 "or learning rate is off "
                                                 "the configuration's")}


@contextlib.contextmanager
def half_batch():
    """The train step's forward and loss see only the first half of each
    batch: the mean is taken over the rest."""
    from leccr_torch.train import step as step_mod

    original = step_mod.TrainStep._backward

    def halved(self, batch, idx, step_no):
        n = idx.shape[0] // 2
        return original(self, {k: v[:n] for k, v in batch.items()}, idx[:n],
                        step_no)

    step_mod.TrainStep._backward = halved
    try:
        yield
    finally:
        step_mod.TrainStep._backward = original


@contextlib.contextmanager
def decay_dropped():
    """The optimizer puts every leaf in a group without weight decay."""
    from leccr_torch.train import optim

    original = optim.classify_params

    def no_decay(*args, **kwargs):
        return {n: lab if lab == "frozen" else
                lab.split("_")[0] + "_no_decay"
                for n, lab in original(*args, **kwargs).items()}

    optim.classify_params = no_decay
    try:
        yield
    finally:
        optim.classify_params = original


FAULTS = (half_batch, decay_dropped)
