"""Dropout for training, and the random generators a training step uses.

`lean_dropout` has the semantics of the JAX package's `LeanDropout`
(`leccr_tpu/ops/dropout.py`): 16-bit random bits thresholded at
min(65535, round(rate · 65536)), survivors scaled by 1/(1−rate) in x's
dtype, zeros for rate ≥ 1, the identity when deterministic or at rate 0.
The bits come from an explicit `torch.Generator` on x's device, so a run is
reproducible from its seeds; they are not JAX's bits (no two frameworks
share a stream), which is why the parity tests run at rate 0.

`checkpoint_block` is the counterpart of flax's `nn.remat` for a block that
draws from these generators: it replays the block's draws in the recompute.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint


@dataclasses.dataclass
class Generators:
    """The random streams of one training forward.

    device: dropout bits, on the device the model runs on.
    host: a CPU generator for the per-layer flash-attention seeds, so that
    drawing a seed never waits on the device.
    aug: a CPU generator for the RandAugment draws (`data.randaugment`),
    the counterpart of the JAX trainer's fold_in(rng, 7).  A stream of its
    own, seeded apart: with RandAugment off nothing draws from it, and
    `device` and `host` draw exactly what they drew without it."""

    device: torch.Generator
    host: torch.Generator
    aug: torch.Generator

    @classmethod
    def from_seed(cls, seed: int, device) -> "Generators":
        device = torch.device(device)
        # other seeds for the host streams: on a CPU model the generators
        # would otherwise be one Mersenne Twister stream thrice over
        return cls(torch.Generator(device=device).manual_seed(seed),
                   torch.Generator().manual_seed(seed ^ 0x5DEECE66D),
                   torch.Generator().manual_seed(seed ^ 0x2545F4914F6CDD1D))

    def flash_seed(self) -> int:
        """One int32 flash-attention seed from [0, 2³¹ − 1)."""
        return int(torch.randint(0, 2 ** 31 - 1, (), generator=self.host))

    def get_state(self):
        return (self.device.get_state(), self.host.get_state(),
                self.aug.get_state())

    def set_state(self, state) -> None:
        self.device.set_state(state[0])
        self.host.set_state(state[1])
        self.aug.set_state(state[2])


def checkpoint_block(block: Callable[..., Any], gen: Optional[Generators],
                     *args: Any) -> Any:
    """block(*args) under `torch.utils.checkpoint` (non-reentrant): its
    activations are dropped after the forward and recomputed in the
    backward, as flax's `nn.remat` does.

    A block draws dropout bits and flash seeds from `gen`, explicit
    generators that checkpoint's `preserve_rng_state` does not restore: the
    recompute would draw anew, its masks would differ from the forward's and
    the gradients would be wrong without an error.  So the generators'
    states are taken before the call and set again at the start of both
    runs: the recompute draws exactly what the forward drew.  The blocks
    draw from nothing else, so the default generators are not saved."""
    if gen is None:
        return checkpoint(block, *args, use_reentrant=False,
                          preserve_rng_state=False)
    state = gen.get_state()

    def replay(*inner):
        gen.set_state(state)
        return block(*inner)

    return checkpoint(replay, *args, use_reentrant=False,
                      preserve_rng_state=False)


def lean_dropout(x: torch.Tensor, rate: float, deterministic: bool,
                 gen: Generators | None,
                 shard: Optional[Tuple[int, int, int]] = None
                 ) -> torch.Tensor:
    """x with elements dropped at `rate` (LeanDropout semantics).

    shard = (dim, m, M): x is slice m of M along `dim` of the tensor a
    one-process run drops (a tensor-parallel rank's features or heads).
    The bits are drawn for the whole tensor and sliced, so the mask is the
    one-process run's and the generator advances as it does there; the
    whole tensor's int32 bits exist for the call (M times x's count)."""
    if deterministic or rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    thresh = min(65535, int(round(rate * 65536.0)))
    shape = list(x.shape)
    if shard is not None:
        dim, m, world = shard
        shape[dim] *= world
    bits = torch.randint(0, 65536, shape, generator=gen.device,
                         device=x.device, dtype=torch.int32)
    if shard is not None:
        n = x.shape[dim]
        bits = bits.narrow(dim, m * n, n)
    scale = torch.tensor(1.0 / (1.0 - rate), dtype=x.dtype, device=x.device)
    return torch.where(bits >= thresh, x * scale, torch.zeros((), dtype=x.dtype,
                                                              device=x.device))
