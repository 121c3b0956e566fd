"""leccr_torch launcher: train and evaluate on the GPU, and export to the
reference's format (the port of the `itr_caption`, `vtr_caption` and
`export` tasks of the JAX package's `run.py`).

    python -m leccr_torch.run --task itr_caption \\
        --config configs/multi30k_fr.yaml --output_dir out/m30k_fr \\
        [--checkpoint weights.pth] [--bs 128] [--epoch 50] [--seed 42] \\
        [--evaluate] [--resume] [--device cpu]
    python -m leccr_torch.run --task vtr_caption \\
        --config configs/msrvtt.yaml --output_dir out/msrvtt [...]
    python -m leccr_torch.run --task export \\
        --checkpoint out/m30k_fr/checkpoints/step_00000040.pt \\
        --export_path out/m30k_fr/reference.pth [--config ...]

itr_caption (images) and vtr_caption (video, evaluated with the
double-sim fusion; the config must name a temporal vision tower) write
`config.json`, `log.txt` (one JSON line per epoch) and `checkpoints/`
under the output dir.  --checkpoint loads initial weights
after the trainer is built: a reference `checkpoint_best.pth`, an OpenAI
CLIP archive, a HF BERT/XLM-R checkpoint (file or directory) or one of the
port's own checkpoints (`models.weights.load_initial_checkpoint`).

export writes the reference-format state_dict (`.pth`) of --checkpoint,
else of the newest checkpoint under --output_dir, else of seeded random
weights (`serve.load_params_for_inference`); without --config it reads the
`config.json` that training wrote beside the checkpoint (or in the output
dir).

A `hdfs://` config is fetched first; a `hdfs://` output dir is staged in a
local directory, mirrored up after each checkpointed epoch, and pulled
down on --resume when the local stage is empty.  --device defaults to the
GPU (it raises when there is none).
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
    "serve": "the rest of serving (ROADMAP §1, 'The rest of serving')",
    "build_index": "the rest of serving (ROADMAP §1, 'The rest of "
                   "serving')",
    "update_index": "the rest of serving (ROADMAP §1, 'The rest of "
                    "serving')",
}
DEFAULT_CONFIGS = {"itr_caption": "configs/multi30k_fr.yaml",
                   "vtr_caption": "configs/msrvtt.yaml"}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--task", default="itr_caption", choices=TASKS)
    p.add_argument("--config", default="",
                   help="config yaml/json (hdfs:// ok); default: "
                        "configs/multi30k_fr.yaml for itr_caption, "
                        "configs/msrvtt.yaml for vtr_caption")
    p.add_argument("--output_dir", default="",
                   help="hdfs:// ok; required for itr_caption")
    p.add_argument("--checkpoint", default="",
                   help="initial weights (itr_caption) or the weights to "
                        "export: a reference .pth, an OpenAI CLIP archive, "
                        "a HF BERT/XLM-R file or dir, or a checkpoint of "
                        "the port's; '' or 'null' for none")
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
    e = p.add_argument_group("export", "--task export only")
    e.add_argument("--export_path", default="",
                   help="destination reference-format .pth")
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


def _config_beside(path: str) -> str:
    """The config.json that training wrote beside a port checkpoint or in
    an output dir (in `checkpoints/` or the output dir), or ''."""
    if not path or path.startswith("hdfs://"):
        return ""
    path = Path(path).resolve()
    for d in (path, *path.parents[:3]):
        if (d / "config.json").is_file():
            return str(d / "config.json")
    return ""


def export_main(args, cfg) -> None:
    """--task export: weights -> a reference-format torch .pth, which the
    reference's strict=False `--checkpoint` load takes
    (image_Retrieval_caption.py:384-387)."""
    from leccr_torch.models.weights import (
        export_reference_state_dict,
        save_reference_checkpoint,
    )
    from leccr_torch.serve import load_params_for_inference

    if not args.export_path:
        raise SystemExit("--task export requires --export_path "
                         "(destination .pth)")
    model = load_params_for_inference(cfg, args.checkpoint or None,
                                      device=args.device)
    sd = export_reference_state_dict(model)
    Path(args.export_path).parent.mkdir(parents=True, exist_ok=True)
    save_reference_checkpoint(sd, args.export_path)
    print(f"### exported {len(sd)} tensors -> {args.export_path}",
          flush=True)


def main(argv=None) -> None:
    args = parse_args(argv)
    if args.task in _UNPORTED:
        raise NotImplementedError(
            f"--task {args.task} comes with {_UNPORTED[args.task]}")
    if args.checkpoint == "null":
        args.checkpoint = ""
    if args.task != "export" and not args.output_dir:
        raise SystemExit(f"--task {args.task} requires --output_dir")
    from leccr_torch.config import load_config

    config_path = args.config
    if not config_path and args.task == "export":
        config_path = _config_beside(args.checkpoint or args.output_dir)
        if not config_path:
            raise SystemExit("--task export needs --config (no config.json "
                             "beside the checkpoint or in the output dir)")
        print(f"### no --config given; using {config_path}")
    if not config_path:
        config_path = str(Path(__file__).resolve().parent.parent
                          / DEFAULT_CONFIGS[args.task])
        print(f"### no --config given; using the {args.task} default: "
              f"{config_path}")
    if config_path.startswith("hdfs://"):
        config_path = _stage_config(config_path)
    cfg = load_config(config_path)
    cfg.task = args.task
    if args.task == "export":
        if args.output_dir:
            cfg.output_dir = args.output_dir
        export_main(args, cfg)
        return
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
    if args.task == "vtr_caption" and cfg.model.vision.kind != "temporal":
        raise SystemExit("--task vtr_caption needs a temporal vision tower "
                         "(model.vision.kind: temporal) in the config")

    Path(cfg.output_dir).mkdir(parents=True, exist_ok=True)
    cfg.save(os.path.join(cfg.output_dir, "config.json"))

    from leccr_torch.train.trainer import Trainer

    trainer = Trainer(cfg, device=args.device)
    if args.checkpoint:
        trainer.load_initial_checkpoint(args.checkpoint)
        print(f"### loaded initial checkpoint from {args.checkpoint}")
    trainer.fit(evaluate_only=args.evaluate)


if __name__ == "__main__":
    main()
