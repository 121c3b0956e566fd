"""Optimizer factory: AdamW with the reference's parameter-group policy
(the port of `leccr_tpu/train/optim.py`).

- AdamW, betas (0.9, 0.98), eps 1e-8 from `OptimConfig`;
- four groups, base/mult × decay/no_decay: no weight decay for flax leaves
  named `bias` or `scale` (every bias and every LayerNorm weight; Embed
  tables, `queries`, `temp` and the CLIP raw params decay), and lr × lr_mult
  for params whose flax path matches one of `lr_mult_paths`;
- params matching `frozen_paths` are in no group: they never move.

Paths are the flax paths (`models.weights.flax_paths`), so the regexes of a
config mean the same params in both packages.  `torch.optim.AdamW` is
optax's `adamw` (decoupled decay lr·wd·p on the pre-update params, eps on
the bias-corrected √v̂).  `legacy_eps` (eps on the uncorrected √v, bias
correction on the step size: transformers < 4.46) and bf16 moment storage
take `AdamW`, this module's own optimizer.
"""

from __future__ import annotations

import math
import re
from typing import Any, Callable, Dict, Iterable, Optional, Sequence, Tuple

import torch
from torch import nn

from leccr_torch.config import OptimConfig
from leccr_torch.models.weights import flax_paths

GROUPS = ("base_decay", "base_no_decay", "mult_decay", "mult_no_decay")
_MOMENT_DTYPES = {"float32": torch.float32, "": torch.float32,
                  None: torch.float32, "bfloat16": torch.bfloat16}


def classify_params(model: nn.Module, lr_mult_paths: Sequence[str] = (),
                    frozen_paths: Sequence[str] = ()) -> Dict[str, str]:
    """Parameter name -> 'frozen' | '{base,mult}_{decay,no_decay}', decided
    on the flax path as the JAX package does."""
    mult_re = [re.compile(p) for p in lr_mult_paths]
    frozen_re = [re.compile(p) for p in frozen_paths]
    labels = {}
    for name, path in flax_paths(model).items():
        joined = "/".join(path)
        if any(r.search(joined) for r in frozen_re):
            labels[name] = "frozen"
            continue
        mult = any(r.search(joined) for r in mult_re)
        no_decay = path[-1] in ("bias", "scale")
        labels[name] = (("mult" if mult else "base")
                        + ("_no_decay" if no_decay else "_decay"))
    return labels


class AdamW(torch.optim.Optimizer):
    """AdamW with moments stored in `moment_dtype` (the math in f32) and,
    with `legacy_eps`, the historical transformers update
    -lr · (√(1−β₂ᵗ)/(1−β₁ᵗ) · m / (√v + eps) + wd · p), both moments
    stored in `moment_dtype`.  Without `legacy_eps` it is optax's adamw
    with mu_dtype: the first moment is stored in `moment_dtype` (and its
    decay β₁ · m taken in that dtype, as optax does), the second in f32."""

    def __init__(self, params, lr: float, betas: Tuple[float, float],
                 eps: float, weight_decay: float, legacy_eps: bool,
                 moment_dtype: torch.dtype):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay))
        self.legacy_eps = legacy_eps
        self.mu_dtype = moment_dtype
        self.nu_dtype = moment_dtype if legacy_eps else torch.float32

    def load_state_dict(self, state_dict) -> None:
        """As torch's, which casts floating state to each parameter's dtype:
        the moments go back to their storage dtypes (a bf16 → f32 → bf16
        round trip is exact)."""
        super().load_state_dict(state_dict)
        for state in self.state.values():
            if "mu" in state:
                state["mu"] = state["mu"].to(self.mu_dtype)
                state["nu"] = state["nu"].to(self.nu_dtype)

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            lr, wd, eps = group["lr"], group["weight_decay"], group["eps"]
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["mu"] = torch.zeros_like(p, dtype=self.mu_dtype)
                    state["nu"] = torch.zeros_like(p, dtype=self.nu_dtype)
                state["step"] += 1
                count = state["step"]
                g = p.grad.float()
                if self.legacy_eps:
                    decayed = b1 * state["mu"].float()
                else:  # optax: b1 · mu in mu's dtype, b1 rounded to it
                    mu = state["mu"]
                    decayed = (mu * torch.tensor(b1, dtype=mu.dtype)).float()
                mu = decayed + (1 - b1) * g
                nu = b2 * state["nu"].float() + (1 - b2) * g * g
                if self.legacy_eps:
                    bias = math.sqrt(1.0 - b2 ** count) / (1.0 - b1 ** count)
                    update = bias * mu / (nu.sqrt() + eps)
                else:
                    update = ((mu / (1.0 - b1 ** count))
                              / ((nu / (1.0 - b2 ** count)).sqrt() + eps))
                p.add_(update + wd * p, alpha=-lr)
                state["mu"].copy_(mu)
                state["nu"].copy_(nu)
        return None


def build_optimizer(
    cfg: OptimConfig,
    model: nn.Module,
    schedule: Callable[[int], float],
    lr_mult_paths: Sequence[str] = (),
    frozen_paths: Sequence[str] = (),
    capturable: bool = False,
) -> Tuple[torch.optim.Optimizer, torch.optim.lr_scheduler.LambdaLR]:
    """(optimizer, scheduler) over the four groups of `classify_params`.
    Group g's learning rate is lr_mult(g) · schedule(step), the step
    counting optimizer steps from 0; call scheduler.step() after each
    optimizer.step().  `capturable`: torch's AdamW keeps its step counts
    on the device and takes its bias corrections there, so that a CUDA
    graph can replay its step (this module's AdamW has no such mode)."""
    labels = classify_params(model, lr_mult_paths, frozen_paths)
    params = dict(model.named_parameters())
    groups = []
    for label in GROUPS:
        members = [params[n] for n, lab in labels.items() if lab == label]
        if members:
            mult = cfg.lr_mult if label.startswith("mult") else 1.0
            groups.append({
                "params": members, "lr": mult, "label": label,
                "weight_decay": (0.0 if label.endswith("no_decay")
                                 else cfg.weight_decay)})
    moment_dtype = _MOMENT_DTYPES[cfg.moment_dtype]
    if cfg.legacy_eps or moment_dtype != torch.float32:
        optimizer = AdamW(groups, lr=1.0, betas=cfg.betas, eps=cfg.eps,
                          weight_decay=0.0, legacy_eps=cfg.legacy_eps,
                          moment_dtype=moment_dtype)
    else:
        optimizer = torch.optim.AdamW(groups, lr=1.0, betas=tuple(cfg.betas),
                                      eps=cfg.eps, weight_decay=0.0,
                                      capturable=capturable)
    # base lr of each group is its multiplier: lr = mult · schedule(step)
    scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, schedule)
    return optimizer, scheduler


def clip_by_global_norm(params: Iterable[torch.Tensor], max_norm: float,
                        sharded: Sequence[torch.Tensor] = (),
                        group: Optional[Any] = None,
                        data_sharded: Sequence[torch.Tensor] = (),
                        data_group: Optional[Any] = None) -> torch.Tensor:
    """optax.clip_by_global_norm on the .grad of params, without a host
    sync: grads are scaled by max_norm / norm where norm ≥ max_norm.
    Returns the norm.

    Under tensor parallelism (`sharded`: the params of `params` that hold
    a slice; `group`: the model group, `parallel.tensor`) the norm is the
    whole model's, JAX's global norm over the sharded arrays: the slices'
    squares summed over the model group, the replicated params' counted
    once.  Under FSDP over processes (`data_sharded`: the params that hold
    a data shard; `data_group`: the data group, `parallel.fsdp`) the
    shards' squares are summed over the data group as well."""
    params = [p for p in params if p.grad is not None]
    grads = [p.grad for p in params]

    def norm_of(gs):
        return torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g.float()) for g in gs]))

    if (group is None or not sharded) and (data_group is None
                                           or not data_sharded):
        norm = norm_of(grads)
    else:
        norm = _sharded_norm(params, norm_of, set(map(id, sharded)), group,
                             set(map(id, data_sharded)), data_group)
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    for g in grads:
        g.mul_(scale.to(g.dtype))
    return norm


def _sharded_norm(params, norm_of, model_ids, group, data_ids, data_group):
    """The global norm of the params' gradients, each held whole, as a
    model slice, as a data shard or as both: the squares of each kind
    summed over the groups that split it."""
    kinds: Dict[Tuple[bool, bool], list] = {}
    for p in params:
        key = (id(p) in model_ids and group is not None,
               id(p) in data_ids and data_group is not None)
        kinds.setdefault(key, []).append(p.grad)
    total = torch.zeros((), device=params[0].grad.device)
    for (by_model, by_data), grads in sorted(kinds.items()):
        squares = norm_of(grads).square()
        if by_model:
            squares = group.sum(squares)
        if by_data:
            squares = data_group.sum(squares)
        total = total + squares
    return total.sqrt()
