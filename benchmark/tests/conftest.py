"""Fixtures of the benchmark's CPU tests: the configuration files' content
at configs/tiny_synth.yaml's widths."""

import copy

import pytest
import torch
import yaml

from benchmark.run import ROOT

# tiny shapes: more threads only contend, the more so under xdist
torch.set_num_threads(2)


def tiny_meta(fused: bool = True) -> dict:
    config = yaml.safe_load((ROOT / "configs" / "tiny_synth.yaml").read_text())
    config["model"]["text"]["fused_attention"] = fused
    config["model"]["vision"]["fused_attention"] = fused
    config["train"]["schedular"] = {"epochs": 2, "num_warmup_steps": 0.1}
    return {"config": config, "schedule_steps": 50}


@pytest.fixture
def tiny():
    from leccr_torch.config import LECCRConfig

    meta = tiny_meta()
    return LECCRConfig.from_dict(copy.deepcopy(meta["config"])), meta
