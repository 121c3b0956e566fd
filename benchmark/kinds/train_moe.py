"""Traffic of kind "train_moe": the "train" kind (`kinds/train.py`: its
input maker, window and `compare_train`) for a configuration whose text
tower is DeepSeek-V2's (`text.kind: deepseek_v2`).

What it adds to the train kind:

- weights by `benchmark.weights_moe` (RMSNorm scales, expert stacks);
- after each compared step and the step after the window, the program's
  recorded expert choices of every MoE layer and call (the layers'
  `routing_record`), by which the reference (`benchmark.reference.
  deepseek_v2`) routes the same step; it reports `routing_mismatches`, the
  share of valid tokens (over the MoE layers, both calls and the compared
  steps) whose own f32 top-k set differs from the program's;
- `router_gap` and `choice_mismatches`, from the program's own router
  input in the first step and the step after the window (`RouterProbe`,
  forward hooks on the MoE layers while those two steps run): the
  router's logits against f32 products of the same rows and the weights
  the program held, and the share of valid tokens whose recorded top-k
  differs from those products' top-k.  The hidden states that reach the
  router differ from the reference's by bf16 rounding, which flips about
  12% of the tokens' top-k sets (`routing_mismatches`' floor); only the
  program's own rows show a fault of the router or of the routing that
  touches fewer tokens than that;
- the optimizer's decay rule of this tower (no decay for RMSNorm scales
  either);
- in the traced slice, kernel 12's device time and its launches, as the
  trace saw them and as its counters counted them (`GroupedSlice`).

`FAULTS`: the train kind's two, a router computed in bf16, a softmax
scale without YaRN's mscale² and a routing that trades one choice for the
next-best expert on every 61st token (~1.6% of the valid tokens).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List

import torch

from benchmark import drivers
from benchmark.reference.deepseek_v2 import (
    leaf_decay,
    reference_loss,
    reference_steps,
)
from benchmark.reference.model import Precision
from benchmark.reference.train import leaf_gap, negligible, norms, settings
from benchmark.tracing import Slice
from benchmark.weights_moe import initial_weights

_train = drivers.load_kind("train")
inputs = _train.inputs
compare_train = _train.compare_train
TEST_SIZE = _train.TEST_SIZE
KERNEL = "grouped_gemm_kernel"


class GroupedSlice(Slice):
    """The train kind's traced slice, with kernel 12's device seconds
    (family "grouped_gemm"), the launches the trace saw of it
    ("grouped_gemm_traced") and those its counters counted
    ("grouped_gemm_counted") in the summary."""

    def __enter__(self) -> "GroupedSlice":
        self._counted = _launches()
        return super().__enter__()

    def __exit__(self, *exc) -> None:
        super().__exit__(*exc)
        self._counted = _launches() - self._counted

    def summary(self) -> dict:
        out = super().summary()
        seconds, count = 0.0, 0
        for e in self._prof.profiler.kineto_results.events():
            if (e.device_type() == torch.autograd.DeviceType.CUDA
                    and KERNEL in e.name()):
                seconds += e.duration_ns() / 1e9
                count += 1
        out["families"]["grouped_gemm"] = seconds
        out["grouped_gemm_traced"] = count
        out["grouped_gemm_counted"] = self._counted
        return out


# the train kind's window takes this kind's slice: `_train` is this kind's
# own copy of that module, which no other kind sees
_train.Slice = GroupedSlice


def _launches() -> int:
    from leccr_torch.ops import grouped_gemm

    return (grouped_gemm.fwd_launches + grouped_gemm.dx_launches
            + grouped_gemm.dw_launches)


class RouterProbe:
    """While open, forward hooks on each MoE layer and its gate: for each
    layer call, the router's logits as the program computed them against
    f32 products of the same input rows and the gate's weight at that
    moment (TF32 off), and the recorded top-k against those products'
    top-k.  Device readings, read by `numbers()`.  A step that a CUDA
    graph replays runs no hook and adds nothing."""

    def __init__(self, layers: List) -> None:
        self.layers = layers
        self.gaps: List[torch.Tensor] = []
        self.differ: List[torch.Tensor] = []
        self.valid: List[torch.Tensor] = []
        self._logits = None
        self._handles = []

    def __enter__(self) -> "RouterProbe":
        for m in self.layers:
            self._handles += [m.gate.register_forward_hook(self._gate),
                              m.register_forward_hook(self._layer)]
        return self

    def __exit__(self, *exc) -> None:
        for h in self._handles:
            h.remove()
        self._handles = []

    def _gate(self, module, args, logits) -> None:
        self._logits = logits.detach()

    @torch.no_grad()
    def _layer(self, m, args, out) -> None:
        x, valid, call = args[:3]
        rows = x.reshape(-1, x.shape[-1]).float()
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            want = rows @ m.gate.weight.float().T
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        self.gaps.append((self._logits.float() - want).abs().max()
                         / want.abs().max())
        k = m.top_k
        top = torch.topk(torch.softmax(want, -1), k, -1).indices
        got = m.routing_record[call].choices.reshape(-1, k)
        v = valid.reshape(-1)
        self.differ.append(((top.sort(-1).values != got.sort(-1).values)
                            .any(-1) & v).sum())
        self.valid.append(v.sum())

    def numbers(self) -> tuple:
        """(the worst relative logit gap, differing valid tokens, valid
        tokens) over the layer calls seen; (0, 0, 0) where none ran."""
        if not self.gaps:
            return 0.0, 0, 0
        return (float(torch.stack(self.gaps).max()),
                int(torch.stack(self.differ).sum()),
                int(torch.stack(self.valid).sum()))


class Driver(_train.Driver):
    def setup(self) -> None:
        """The train kind's set-up, keeping each compared step's
        routing."""
        from leccr_torch.train.step import make_train_step

        self.model = self._model()
        self.step = make_train_step(self.cfg, self.model,
                                    self.meta["schedule_steps"])
        self.pool = inputs(self.mix, self.cfg, self.seed, self.device)
        self.compared = self.mix["compared_steps"]
        self.losses, self.routes = [], []
        self.probes = [RouterProbe(self.step.moe_layers)]
        for k in range(max(self.mix["warmup_steps"], self.compared)):
            with (self.probes[0] if k == 0 else contextlib.nullcontext()):
                self.losses.append(self.step.run(
                    self.pool[k % len(self.pool)], k))
            if k < self.compared:
                self.routes.append(self._recorded())
            if k == 0:
                self.grad_norms = self._first_gradients()
            if k == self.compared - 1:
                self.sync()
                self.changes = self._changes()
            self.beat()
        self.sync()
        self.losses = [t.cpu() for t in self.losses[:self.compared]]
        self.next_step = max(self.mix["warmup_steps"], self.compared)

    def _recorded(self) -> dict:
        """{call: [each MoE layer's choices [B, L, k]]}, copies on the
        device."""
        layers = self.step.moe_layers
        return {call: [m.routing_record[call].choices.clone()
                       for m in layers]
                for call in layers[0].routing_record}

    def after_window(self) -> None:
        probe = RouterProbe(self.step.moe_layers)
        with probe:
            super().after_window()
        self.probes.append(probe)
        self.late["routes"] = self._recorded()

    def _router_numbers(self) -> tuple:
        """(`router_gap`, `choice_mismatches`) of the probed steps."""
        got = [p.numbers() for p in self.probes]
        return (max(g for g, _, _ in got),
                sum(d for _, d, _ in got) / max(sum(n for _, _, n in got), 1))

    def _weights(self) -> Dict[str, torch.Tensor]:
        return initial_weights(self.shapes, self.cfg.model.temp, self.seed,
                               self.device)

    def _reference(self, prec=None):
        config, late = self.meta["config"], self.late
        ref = reference_steps(self._weights(), config,
                              self.pool[:self.compared],
                              list(range(self.compared)),
                              self.meta["schedule_steps"], prec, self.routes)
        ref["late"], late_mism = reference_loss(
            late["weights"], config, late["batch"], late["step"], prec,
            late["routes"])
        differ, valid = (a + b for a, b in zip(ref["mismatched"], late_mism))
        ref["routing_mismatches"] = differ / max(valid, 1)
        ref["routing_by_layer"] = {f"{c}.{j}": a / max(n, 1) for (c, j), (a, n)
                                   in sorted(ref["by_layer"].items())}
        return ref

    def _numbers(self, ref, mismatches: float) -> Dict[str, tuple]:
        out = compare_train(self.losses + [self.late["losses"]],
                            ref["losses"] + [ref["late"]], self.grad_norms,
                            self.changes, ref, mismatches)
        out["routing_mismatches"] = (
            ref["routing_mismatches"], "valid tokens whose f32 top-k set "
            "differs from the program's, over the MoE layers, both calls "
            "and the compared steps")
        gap, choices = self._router_numbers()
        out["router_gap"] = (gap, "router logits of the first step and the "
                             "step after the window, worst layer and call, "
                             "against f32 products of the program's rows")
        out["choice_mismatches"] = (
            choices, "valid tokens whose recorded top-k differs from the "
            "top-k of f32 products of the program's router rows, first "
            "step and the step after the window")
        return out

    def check(self) -> Dict[str, tuple]:
        ref = self._reference()
        return self._numbers(ref, optimizer_mismatches(
            self.groups, self.meta["config"], self.meta["schedule_steps"],
            self.late["step"] + 1))

    def readings(self, control: bool) -> dict:
        """The program's numbers, and the fp8 control's in its place."""
        self.after_window()
        self.release()
        ref = self._reference()
        out = {"program": drivers.values(self._numbers(
            ref, optimizer_mismatches(self.groups, self.meta["config"],
                                      self.meta["schedule_steps"],
                                      self.late["step"] + 1)))}
        out["program"]["change_gap_whole_leaves"] = leaf_gap(
            norms(self.changes), norms(ref["change"]),
            negligible(ref["grad_norms"]))[0]
        out["program"]["routing_by_layer"] = ref["routing_by_layer"]
        if control:
            ctl = self._reference(Precision(fp8=True))
            numbers = compare_train(
                ctl["losses"] + [ctl["late"]], ref["losses"] + [ref["late"]],
                ctl["grad_norms"], ctl["change"], ref, 0.0)
            numbers["routing_mismatches"] = (ctl["routing_mismatches"], "")
            out["control"] = drivers.values(numbers)
            out["control"]["routing_by_layer"] = ctl["routing_by_layer"]
        return out


def optimizer_mismatches(groups: Dict[str, tuple], config: dict,
                         total_steps: int, step_no: int) -> float:
    """The train kind's count of leaves off the configuration's decay rule
    or schedule, with this tower's rule (`reference.deepseek_v2.
    leaf_decay`)."""
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


@contextlib.contextmanager
def router_bf16():
    """The MoE router's logits and softmax computed in bf16."""
    from leccr_torch.models import deepseek

    original = deepseek.Router.forward

    def bf16(self, x):
        return torch.nn.functional.linear(
            x.to(torch.bfloat16), self.weight.to(torch.bfloat16)).float()

    deepseek.Router.forward = bf16
    try:
        yield
    finally:
        deepseek.Router.forward = original


@contextlib.contextmanager
def scale_without_mscale():
    """The attention's softmax scale (q_head_dim)^-½ alone, without YaRN's
    mscale² (set when the model is built)."""
    from leccr_torch.models import deepseek

    original = deepseek.softmax_scale
    deepseek.softmax_scale = lambda cfg: (
        cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5
    try:
        yield
    finally:
        deepseek.softmax_scale = original


@contextlib.contextmanager
def misroute_share(stride: int = 61):
    """Every `stride`-th token trades its k-th choice for its next-best
    expert (their probabilities swapped before the top-k): a routing fault
    on ~1/`stride` of the tokens, fewer than bf16 rounding flips."""
    from leccr_torch.models import deepseek

    original = deepseek.route

    def faulty(scores, valid, top_k, held, offset=0):
        ranked = torch.topk(scores, top_k + 1, dim=-1).indices
        rows = torch.arange(0, scores.shape[0], stride, device=scores.device)
        kth, nxt = ranked[rows, top_k - 1], ranked[rows, top_k]
        swapped = scores.clone()
        swapped[rows, kth] = scores[rows, nxt]
        swapped[rows, nxt] = scores[rows, kth]
        return original(swapped, valid, top_k, held, offset)

    deepseek.route = faulty
    try:
        yield
    finally:
        deepseek.route = original


half_batch, decay_dropped = _train.half_batch, _train.decay_dropped
FAULTS = (half_batch, decay_dropped, router_bf16, scale_without_mscale,
          misroute_share)
