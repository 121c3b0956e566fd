"""leccr_torch launcher: train and evaluate on the GPU, export to the
reference's format, and build, maintain and serve a retrieval index (the
port of the tasks of the JAX package's `run.py`).

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

Serving (the port of the JAX launcher's build_index, update_index and
serve tasks):

    python -m leccr_torch.run --task build_index \
        --config out/m30k_fr/config.json --output_dir out/m30k_fr \
        --index out/m30k_fr/index [--split test] [--int8] \
        [--ivf [--ivf_clusters C] [--ivf_recall 0.95]] [--serve_bs 64]
    python -m leccr_torch.run --task update_index --output_dir out/m30k_fr \
        --index out/m30k_fr/index [--remove_ids a,b] [--add_new] \
        [--ivf_recall 0.95]
    python -m leccr_torch.run --task serve --output_dir out/m30k_fr \
        --index out/m30k_fr/index --port 8080

build_index embeds the split's images (or videos) with their MLLM
captions through the weights (--checkpoint, else the newest checkpoint
under --output_dir, else seeded random weights) and saves an exact index
(`serve.save_index`; --int8 quantizes it) or an IVF index
(`serve_ann.save_ivf`; --ivf_recall stamps the smallest nprobe reaching
that recall@10).  update_index removes items by id and, with --add_new,
embeds only the split's items the index lacks.  serve answers POST
/search, GET /healthz and GET /stats (`serve_frontend`) until SIGINT.
The serving tasks read --config, else the config.json beside the
checkpoint or in the output dir; a save of the JAX package serves as is.

A `hdfs://` config is fetched first; a `hdfs://` output dir is staged in a
local directory, mirrored up after each checkpointed epoch, and pulled
down on --resume when the local stage is empty.  --device defaults to the
GPU (it raises when there is none).

Data parallelism (`parallel.mesh.DataMesh`, one process per GPU):

    python -m leccr_torch.run --task itr_caption --devices 4 ...
    torchrun --nnodes 2 --nproc_per_node 8 -m leccr_torch.run \
        --task itr_caption --multihost ...

--devices N (0 = every local GPU) above 1 spawns N training processes, one
per GPU (cuda:r, NCCL), and waits for them; the serving tasks instead
shard the index over the first N GPUs (`serve --devices N`: the exact
index row-sharded; build_index and update_index write an unsharded save
as ever).  With one device the run stays in this process.  --multihost
joins the world that torchrun's environment describes (RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR / MASTER_PORT); only rank 0 writes config.json,
logs and checkpoints.  Asking for more GPUs than the host has raises.
`--device cpu --devices N` runs N gloo processes on the CPU (the tests'
path).
"""

from __future__ import annotations

import argparse
import os
import re
import tempfile
from pathlib import Path

TASKS = ("itr_caption", "vtr_caption", "serve", "build_index",
         "update_index", "export")
SERVING_TASKS = ("serve", "build_index", "update_index")
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
    p.add_argument("--multihost", action="store_true",
                   help="join the data-parallel world of torchrun's "
                        "environment (RANK, WORLD_SIZE, LOCAL_RANK, "
                        "MASTER_ADDR, MASTER_PORT)")
    p.add_argument("--devices", default=0, type=int,
                   help="use the first N local GPUs (0 = all): N training "
                        "processes, or the serving index sharded over N; "
                        "with --device cpu, N gloo processes")
    g = p.add_argument_group("serve", "--task serve only")
    g.add_argument("--index", default="",
                   help="saved index dir (serve.save_index or "
                        "serve_ann.save_ivf; hdfs:// ok)")
    g.add_argument("--host", default="127.0.0.1")
    g.add_argument("--port", default=8080, type=int,
                   help="0 picks a free port")
    g.add_argument("--serve_bs", default=64, type=int,
                   help="embed/search batch size = max coalesced batch")
    g.add_argument("--max_delay_ms", default=5.0, type=float,
                   help="how long the first queued query waits for "
                        "followers before dispatching")
    g.add_argument("--max_pending", default=1024, type=int,
                   help="admission bound in queries; beyond it /search "
                        "returns 503 (0 = unbounded)")
    e = p.add_argument_group("export", "--task export only")
    e.add_argument("--export_path", default="",
                   help="destination reference-format .pth")
    b = p.add_argument_group("build_index", "--task build_index only")
    b.add_argument("--split", default="test", choices=["test", "val"],
                   help="which dataset split's corpus to index")
    b.add_argument("--int8", action="store_true",
                   help="quantize the index rows to int8 (4x smaller; "
                        "order kept to ~1e-3 of score)")
    b.add_argument("--ivf", action="store_true",
                   help="cluster into an IVF approximate-NN index "
                        "(serve_ann; probe cost independent of corpus "
                        "size)")
    b.add_argument("--ivf_clusters", default=0, type=int,
                   help="IVF cluster count (0 = auto, ~4*sqrt(N))")
    b.add_argument("--ivf_recall", default=0.0, type=float,
                   help="calibrate the smallest nprobe reaching this "
                        "recall@10 (self-query sample vs the exact "
                        "probe) and save it as the index's default "
                        "(0 = skip); update_index too")
    u = p.add_argument_group("update_index", "--task update_index only")
    u.add_argument("--remove_ids", default="",
                   help="comma-separated item ids to drop from the index")
    u.add_argument("--add_new", action="store_true",
                   help="embed and add the split's items not yet in the "
                        "index (existing rows are never embedded again)")
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


def _corpus_split(args, cfg):
    """The dataset split whose visual corpus gets indexed (any language's
    split carries the same images or videos).  build_datasets writes the
    synthetic dataset first and points cfg.data at it, vocab included,
    which the Embedder's tokenizer reads."""
    from leccr_torch.train.trainer import build_datasets

    _, val_ds, test_ds = build_datasets(cfg)
    splits = test_ds if args.split == "test" else val_ds
    return next(iter(splits.values()))


def _embed_corpus(emb, cfg, ds, ids):
    """An exact ImageIndex of the given item ids (a subset of ds's), with
    their MLLM captions, through the Embedder's model."""
    import numpy as np

    captions = [ds.generated[i] for i in ids]
    if cfg.model.vision.kind == "temporal":
        pos = {im: i for i, im in enumerate(ds.index.image_ids)}
        pairs = [ds.get(pos[i])[0] for i in ids]  # ds.get is positional
        return emb.build_video_index(
            np.stack([p[0] for p in pairs]), captions,
            frame_masks=np.stack([p[1] for p in pairs]), ids=ids)
    return emb.build_image_index(
        [ds.image_path(i) for i in ids], captions, ids=ids)


def _embedder(args, cfg):
    from leccr_torch.serve import Embedder

    return Embedder.from_config(cfg, checkpoint=args.checkpoint or None,
                                batch_size=args.serve_bs,
                                device=args.device)


def _calibrated(ivf, target: float, what: str):
    """ivf stamped with the smallest nprobe reaching recall@10 >= target
    (measured on the bank as deployed)."""
    import dataclasses

    from leccr_torch.serve_ann import calibrate_nprobe

    nprobe, recall = calibrate_nprobe(ivf, target_recall=target)
    print(f"### {what} nprobe={nprobe} (recall@10 {recall:.3f} >= "
          f"{target})", flush=True)
    return dataclasses.replace(ivf, default_nprobe=nprobe)


def build_index_main(args, cfg) -> None:
    """--task build_index: weights + a dataset split -> a saved serving
    index (exact, int8, or IVF)."""
    from leccr_torch.serve import quantize_index, save_index
    from leccr_torch.serve_ann import build_ivf_index, quantize_ivf, save_ivf

    if not args.index:
        raise SystemExit("--task build_index requires --index "
                         "(the output directory for serve.save_index)")
    ds = _corpus_split(args, cfg)
    emb = _embedder(args, cfg)
    index = _embed_corpus(emb, cfg, ds, list(ds.index.image_ids))
    if args.ivf:
        ivf = build_ivf_index(index, n_clusters=args.ivf_clusters or None,
                              device=emb.device)
        if args.int8:
            ivf = quantize_ivf(ivf)
        if args.ivf_recall:
            ivf = _calibrated(ivf, args.ivf_recall, "calibrated")
        save_ivf(ivf, args.index)
        print(f"### built IVF index: {ivf.n_valid} items, "
              f"C={ivf.n_clusters} cap={ivf.capacity}"
              + (" (int8)" if ivf.quantized else "")
              + f" -> {args.index}", flush=True)
        return
    if args.int8:
        index = quantize_index(index)
    save_index(index, args.index)
    print(f"### built index: {index.n_valid} items"
          + (" (int8)" if index.quantized else "")
          + f" -> {args.index}", flush=True)


def update_index_main(args, cfg) -> None:
    """--task update_index: remove items by id and/or embed and add the
    split's new items (exact: merge_indexes; IVF: add_to_ivf, no new
    clustering).  Existing rows keep their bytes, int8 ones too; the model
    is loaded only when there is something to embed."""
    from leccr_torch.serve import (load_index, merge_indexes,
                                   quantize_index, remove_from_index,
                                   save_index)
    from leccr_torch.serve_ann import (add_to_ivf, is_ivf_save, load_ivf,
                                       remove_from_ivf, save_ivf)

    if not args.index:
        raise SystemExit("--task update_index requires --index "
                         "(an existing saved index directory)")
    removes = [s for s in args.remove_ids.split(",") if s]
    if not removes and not args.add_new and not args.ivf_recall:
        raise SystemExit("--task update_index needs --remove_ids, "
                         "--add_new, and/or --ivf_recall")
    ivf = is_ivf_save(args.index)
    if args.ivf_recall and not ivf:
        raise SystemExit("--ivf_recall applies to IVF indexes only")
    index = (load_ivf if ivf else load_index)(args.index, args.device)
    n0 = index.n_valid
    if removes:
        index = (remove_from_ivf if ivf else remove_from_index)(
            index, removes)
    added = 0
    if args.add_new:
        ds = _corpus_split(args, cfg)
        have = set(index.ids)
        new_ids = [i for i in ds.index.image_ids if i not in have]
        if new_ids:
            new = _embed_corpus(_embedder(args, cfg), cfg, ds, new_ids)
            if ivf:
                index = add_to_ivf(index, new)
            else:
                if index.quantized:
                    new = quantize_index(new)
                index = merge_indexes(index, new)
            added = len(new_ids)
    if ivf and args.ivf_recall:
        # adds live under a partition not fit to them: measure again
        index = _calibrated(index, args.ivf_recall, "recalibrated")
    (save_ivf if ivf else save_index)(index, args.index)
    print(f"### updated index: {n0} -> {index.n_valid} items "
          f"(+{added} -{len(removes)}) -> {args.index}", flush=True)


def serve_main(args, cfg) -> None:
    """--task serve: weights + a saved index -> the HTTP retrieval service,
    until SIGINT."""
    import threading

    from leccr_torch.serve import load_index
    from leccr_torch.serve_ann import is_ivf_save, load_ivf
    from leccr_torch.serve_frontend import DynamicBatcher, ServingFrontend

    if not args.index:
        raise SystemExit("--task serve requires --index "
                         "(a serve.save_index directory)")
    if cfg.data.dataset == "synthetic":
        # a config from a synthetic-data run: materialize the corpus paths
        # (tokenizer vocab included) as the trainer does
        from leccr_torch.train.trainer import build_datasets

        build_datasets(cfg)
    emb = _embedder(args, cfg)
    if is_ivf_save(args.index):
        index = load_ivf(args.index, emb.device)
        print(f"### IVF index: {index.n_valid} items, "
              f"C={index.n_clusters}"
              + (" (int8)" if index.quantized else ""), flush=True)
    else:
        shard_over = getattr(args, "shard_over", None)
        index = load_index(args.index, emb.device, mesh=shard_over)
        print(f"### index: {index.n_valid} items"
              + (" (int8)" if index.quantized else "")
              + (f", sharded over {len(shard_over)} devices"
                 if shard_over else ""), flush=True)
    batcher = DynamicBatcher(emb, index, max_delay=args.max_delay_ms / 1000,
                             max_pending=args.max_pending or None)
    frontend = ServingFrontend(batcher, host=args.host, port=args.port)
    try:
        # warm the search path so the first real query pays no set-up; a
        # video model's slot-carrying index also gets the minmax fusion,
        # the double-sim ranking its clients use
        batcher.search(["warmup"], k=min(10, index.n_valid))
        if (cfg.model.vision.kind == "temporal"
                and getattr(index, "slots", None) is not None):
            batcher.search(["warmup"], k=min(10, index.n_valid),
                           fusion="minmax")
        print(f"### serving on http://{frontend.host}:{frontend.port} "
              "(POST /search, GET /healthz, GET /stats)", flush=True)
        threading.Event().wait()
    except KeyboardInterrupt:
        print("### serve: interrupted, shutting down", flush=True)
    finally:
        frontend.close()


def _on_cpu(args) -> bool:
    import torch

    return args.device is not None and torch.device(args.device).type == "cpu"


def local_devices(args) -> int:
    """The device count --devices names on this host: N, or with 0 every
    local GPU (one on the CPU).  More GPUs than the host has raise."""
    import torch

    if _on_cpu(args):
        return max(args.devices, 1)
    have = torch.cuda.device_count()
    want = args.devices or have
    if want > have:
        raise ValueError(f"--devices {args.devices} asks for {want} GPUs; "
                         f"this host has {have}")
    return max(want, 1)


def serving_devices(args, n: int):
    """The devices a serving index is sharded over: the first n GPUs (n
    copies of the CPU with --device cpu); None for one device."""
    if n <= 1:
        return None
    return ["cpu"] * n if _on_cpu(args) else [f"cuda:{i}" for i in range(n)]


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_ranks(argv, n: int) -> None:
    """Run this launcher's task in n processes, rank r on cuda:r (or the
    CPU), as torchrun would: each child gets --multihost and torchrun's
    environment.  Waits for all; the first failure stops the rest and
    raises SystemExit naming that rank and its exit code."""
    import subprocess
    import sys
    import time

    port = _free_port()
    keep, skip = [], False
    for a in argv:
        if skip:
            skip = False
        elif a == "--devices":
            skip = True
        elif not a.startswith("--devices="):
            keep.append(a)
    procs = []
    for rank in range(n):
        env = {**os.environ, "RANK": str(rank), "LOCAL_RANK": str(rank),
               "WORLD_SIZE": str(n), "MASTER_ADDR": "localhost",
               "MASTER_PORT": str(port)}
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "leccr_torch.run", *keep, "--multihost"],
            env=env))
    try:
        while True:
            codes = [p.poll() for p in procs]
            failed = [c for c in codes if c not in (None, 0)]
            if failed:
                raise SystemExit(
                    f"rank {codes.index(failed[0])} of {n} exited with "
                    f"{failed[0]}")
            if all(c == 0 for c in codes):
                return
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


def main(argv=None) -> None:
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    mesh = None
    if args.multihost:
        if args.task in SERVING_TASKS or args.task == "export":
            raise ValueError(f"--multihost runs the training tasks, not "
                             f"--task {args.task}")
        from leccr_torch.parallel.mesh import DataMesh

        mesh = DataMesh.from_env(device="cpu" if _on_cpu(args) else None)
    else:
        n = local_devices(args)
        if n > 1 and args.task not in SERVING_TASKS + ("export",):
            spawn_ranks(argv, n)
            return
        args.shard_over = (serving_devices(args, n) if args.task == "serve"
                           else None)
    try:
        _main(args, mesh)
    finally:
        if mesh is not None:
            mesh.destroy()


def _main(args, mesh) -> None:
    if args.checkpoint == "null":
        args.checkpoint = ""
    if args.task != "export" and not args.output_dir:
        raise SystemExit(f"--task {args.task} requires --output_dir")
    from leccr_torch.config import load_config

    config_path = args.config
    if not config_path and args.task not in DEFAULT_CONFIGS:
        config_path = _config_beside(args.checkpoint or args.output_dir)
        if not config_path:
            raise SystemExit(f"--task {args.task} needs --config (no "
                             "config.json beside the checkpoint or in the "
                             "output dir)")
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
    if args.task in SERVING_TASKS:
        {"serve": serve_main, "build_index": build_index_main,
         "update_index": update_index_main}[args.task](args, cfg)
        return
    if args.task == "vtr_caption" and cfg.model.vision.kind != "temporal":
        raise SystemExit("--task vtr_caption needs a temporal vision tower "
                         "(model.vision.kind: temporal) in the config")

    Path(cfg.output_dir).mkdir(parents=True, exist_ok=True)
    if mesh is None or mesh.is_main:
        cfg.save(os.path.join(cfg.output_dir, "config.json"))

    from leccr_torch.train.trainer import Trainer

    trainer = Trainer(cfg, device=args.device, mesh=mesh)
    if args.checkpoint:
        trainer.load_initial_checkpoint(args.checkpoint)
        trainer.print(f"### loaded initial checkpoint from {args.checkpoint}")
    trainer.fit(evaluate_only=args.evaluate)


if __name__ == "__main__":
    main()
