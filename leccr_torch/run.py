"""leccr_torch launcher: train and evaluate on the GPU (the port of the
`itr_caption` task of the JAX package's `run.py`).

    python -m leccr_torch.run --task itr_caption \\
        --config configs/multi30k_fr.yaml --output_dir out/m30k_fr \\
        [--bs 128] [--epoch 50] [--seed 42] [--evaluate] [--resume] \\
        [--device cpu]

It writes `config.json`, `log.txt` (one JSON line per epoch) and
`checkpoints/` under the output dir.  A `hdfs://` config is fetched first;
a `hdfs://` output dir is staged in a local directory, mirrored up after
each checkpointed epoch, and pulled down on --resume when the local stage
is empty.  --device defaults to the GPU (it raises when there is none).
"""

from __future__ import annotations

import argparse
import os
import re
import tempfile
from pathlib import Path

TASKS = ("itr_caption", "vtr_caption", "serve", "build_index",
         "update_index", "export")
_UNPORTED = {
    "vtr_caption": "the video path of the port (ROADMAP §1, 'The video "
                   "path')",
    "serve": "the rest of serving (ROADMAP §1, 'The rest of serving')",
    "build_index": "the rest of serving (ROADMAP §1, 'The rest of "
                   "serving')",
    "update_index": "the rest of serving (ROADMAP §1, 'The rest of "
                    "serving')",
    "export": "checkpoint import and export (ROADMAP §1, 'Tokenizers, the "
              "CLIP text tower, and checkpoint import and export')",
}
DEFAULT_CONFIGS = {"itr_caption": "configs/multi30k_fr.yaml"}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--task", default="itr_caption", choices=TASKS)
    p.add_argument("--config", default="",
                   help="config yaml/json (hdfs:// ok); default: "
                        "configs/multi30k_fr.yaml for itr_caption")
    p.add_argument("--output_dir", required=True, help="hdfs:// ok")
    p.add_argument("--checkpoint", default="",
                   help="initial weights: only '' or 'null' (none) so far")
    p.add_argument("--seed", default=None, type=int,
                   help="override the config's train.seed")
    p.add_argument("--epoch", default=-1, type=int,
                   help="override config epochs")
    p.add_argument("--bs", default=-1, type=int,
                   help="override the train batch size")
    p.add_argument("--evaluate", action="store_true")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; 'cpu' for tests)")
    return p.parse_args(argv)


def _stage_config(config_path: str) -> str:
    """A local copy of a hdfs:// config."""
    from leccr_torch.utils import io as uio

    if not uio.exists(config_path):
        raise FileNotFoundError(f"config not found: {config_path}")
    local = tempfile.NamedTemporaryFile(
        suffix=Path(config_path).suffix or ".yaml", delete=False)
    local.close()
    # `hdfs dfs -get` refuses to overwrite a file: free the name first
    os.unlink(local.name)
    uio.copy(config_path, local.name)
    return local.name


def _stage_output_dir(output_dir: str, resume: bool) -> str:
    """The local stage of a hdfs:// output dir (a fixed path, so a
    restarted job reuses it); on resume with no local checkpoints, the
    remote dir's contents are pulled down first."""
    from leccr_torch.utils import io as uio

    local_out = os.path.join(
        tempfile.gettempdir(), "leccr_stage",
        re.sub(r"[^\w.-]+", "_", output_dir[len("hdfs://"):]))
    if resume and not os.path.exists(
            os.path.join(local_out, "checkpoints")) and uio.exists(
            output_dir):
        uio.stage_remote_dir(output_dir, local_out)
        print(f"### staged {output_dir} -> {local_out}", flush=True)
    return local_out


def main(argv=None) -> None:
    args = parse_args(argv)
    if args.task in _UNPORTED:
        raise NotImplementedError(
            f"--task {args.task} comes with {_UNPORTED[args.task]}")
    if args.checkpoint and args.checkpoint != "null":
        raise NotImplementedError(
            "--checkpoint (reference and OpenAI/HF weights) comes with "
            "checkpoint import (ROADMAP §1, 'Tokenizers, the CLIP text "
            "tower, and checkpoint import and export')")
    from leccr_torch.config import load_config

    config_path = args.config
    if not config_path:
        config_path = str(Path(__file__).resolve().parent.parent
                          / DEFAULT_CONFIGS[args.task])
        print(f"### no --config given; using the {args.task} default: "
              f"{config_path}")
    if config_path.startswith("hdfs://"):
        config_path = _stage_config(config_path)
    cfg = load_config(config_path)
    cfg.task = args.task
    cfg.output_dir = args.output_dir
    if args.output_dir.startswith("hdfs://"):
        cfg.remote_output_dir = args.output_dir
        cfg.output_dir = _stage_output_dir(args.output_dir, args.resume)
    if args.seed is not None:
        cfg.train.seed = args.seed
    if args.epoch > 0:
        cfg.train.schedular.epochs = args.epoch
        print(f"### set epochs to: {args.epoch}", flush=True)
    if args.bs > 0:
        cfg.train.batch_size_train = args.bs
    if args.resume:
        cfg.train.resume = True

    Path(cfg.output_dir).mkdir(parents=True, exist_ok=True)
    cfg.save(os.path.join(cfg.output_dir, "config.json"))

    from leccr_torch.train.trainer import Trainer

    Trainer(cfg, device=args.device).fit(evaluate_only=args.evaluate)


if __name__ == "__main__":
    main()
