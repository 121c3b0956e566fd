"""Input pipeline: deterministic shuffled sampling, offline tokenization,
bucketed widths, threaded decode, device prefetch (the port of
`leccr_tpu/data/pipeline.py`).

- texts and MLLM captions are tokenized ONCE at construction, not per step;
- batches are padded to a small set of bucket widths
  (`DataConfig.token_buckets`), as in the JAX package, so a batch's
  arrays equal JAX's bit for bit;
- the shuffle is a seeded permutation of the full index set per epoch
  (`shard_indices`, DistributedSampler parity, drop_last for training);
- image decode and crop run in a thread pool; normalization and the flips
  happen on the device (`data.images.preprocess_train_images`);
- a video batch carries "vision" frames [B, max_frames, Df] f32 and
  "vision_mask" [B, max_frames] bool (True = a real frame) instead of
  uint8 images and flips.

`TrainLoader` tokenizes its texts with the native C++ encoder of its
WordPiece or Unigram tokenizer where the library builds
(`data.native_tokenizer`; the same ids), else with the Python one, and
says which in `TrainLoader.native`.  A CLIP BPE caption tokenizer gives
77-wide rows padded with 0, and the caption mask is `ids != 0`.

Errors: every background thread hands its exception to the consuming
thread, which raises it at its next batch.  A failing sample read never
ends an epoch early, and never leaves the consumer waiting on a queue that
no thread will fill.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterable, Iterator, List, Sequence

import numpy as np
import torch

from leccr_torch.config import DataConfig
from leccr_torch.data.native_tokenizer import native_counterpart
from leccr_torch.data.text import normalize_caption, video_id_of

_END = object()


class _Failure:
    """An exception raised on a producer thread, in transit."""

    def __init__(self, exc: BaseException):
        self.exc = exc


def background(produce: Callable[[Callable[[Any], bool]], None],
               depth: int = 2) -> Iterator:
    """Run `produce(put)` on a thread and yield what it puts, at most
    `depth` items ahead.  `put(item)` returns False once the consumer has
    stopped (the producer should return then).  An exception in `produce`
    is raised here, in the consumer, after the items put before it."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def run():
        try:
            produce(put)
        except BaseException as exc:  # handed to the consumer, raised there
            put(_Failure(exc))
        else:
            put(_END)

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, _Failure):
                raise item.exc
            yield item
    finally:
        stop.set()
        thread.join()


def background_iter(iterable: Iterable, depth: int = 2) -> Iterator:
    """`iterable` advanced on a background thread, `depth` items ahead
    (see `background`)."""
    return background(lambda put: _drain_into(iterable, put), depth)


def _drain_into(iterable: Iterable, put, fn=lambda x: x) -> None:
    """put(fn(x)) for each item of `iterable` until the consumer stops;
    closes `iterable` (a generator's own threads stop with it)."""
    try:
        for item in iterable:
            if not put(fn(item)):
                return
    finally:
        close = getattr(iterable, "close", None)
        if close is not None:
            close()


def shard_indices(
    n: int,
    epoch: int,
    seed: int,
    process_count: int = 1,
    process_index: int = 0,
    shuffle: bool = True,
    drop_last: bool = True,
) -> np.ndarray:
    """Deterministic global permutation, sharded per process (parity with
    torch DistributedSampler: pad-to-even when not dropping)."""
    order = np.arange(n)
    if shuffle:
        order = np.random.RandomState(seed + epoch).permutation(n)
    if drop_last:
        per = n // process_count
        order = order[: per * process_count]
    else:
        per = -(-n // process_count)
        pad = per * process_count - n
        if pad:
            order = np.concatenate([order, order[:pad]])
    return order[process_index::process_count]


def bucket_width(lengths: Sequence[int], buckets: Sequence[int]) -> int:
    """Smallest bucket ≥ the longest sequence (clamped to the largest)."""
    need = max(lengths)
    for b in sorted(buckets):
        if b >= need:
            return b
    return sorted(buckets)[-1]


def pad_token_batch(
    token_lists: Sequence[Sequence[int]], width: int, pad_id: int = 0
):
    ids = np.full((len(token_lists), width), pad_id, np.int32)
    mask = np.zeros((len(token_lists), width), np.int32)
    for i, toks in enumerate(token_lists):
        toks = list(toks)[:width]
        ids[i, : len(toks)] = toks
        mask[i, : len(toks)] = 1
    return ids, mask


def _feats_batch(caps, width: int):
    """Caption features [n_i, D] padded to [len(caps), width, D] + mask."""
    feats = [np.asarray(c, np.float32) for c in caps]
    arr = np.zeros((len(feats), width, feats[0].shape[1]), np.float32)
    msk = np.zeros((len(feats), width), np.int32)
    for i, f in enumerate(feats):
        arr[i, : f.shape[0]] = f
        msk[i, : f.shape[0]] = 1
    return arr, msk


def _feats_width(dataset) -> int:
    """The dataset-global caption-feature length (fixed batch shapes)."""
    return max(np.asarray(v).shape[0] for v in dataset.generated.values())


def _is_clip_bpe(tokenizer) -> bool:
    """CLIP's BPE encodes to fixed 77-wide rows with no [CLS]/<s>."""
    return not hasattr(tokenizer, "cls_id")


def _encode_rows(tokenizer, texts: List[str], max_len: int
                 ) -> List[List[int]]:
    """Tokenize a text list to unpadded id rows."""
    ids, mask = tokenizer.encode(texts, max_len)
    return [row[: int(m.sum())].tolist() for row, m in zip(ids, mask)]


class TrainLoader:
    """Epoch iterator over numpy batches for the train step.

    Yields dicts with keys matching LECCRModel.forward's batch contract
    plus `idx` ([B] int32) and `flip` ([B] bool)."""

    def __init__(self, dataset, tokenizer, cfg: DataConfig, batch_size: int,
                 num_workers: int = 4, caption_tokenizer=None,
                 prefetch: int = 2):
        self.dataset = dataset
        self.cfg = cfg
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.tokenizer = tokenizer
        self.caption_tokenizer = caption_tokenizer or tokenizer
        # the native encoder of the text tokenizer where the library builds
        self._encoder = native_counterpart(tokenizer) or tokenizer
        self.native = self._encoder is not tokenizer
        self._tokenize_all()

    def _tokenize_all(self) -> None:
        """Offline tokenization of every (sample, language) text and every
        MLLM caption."""
        ds = self.dataset
        max_len = self.cfg.max_tokens
        self.text_tokens: List[List[List[int]]] = []
        for k, cmap in enumerate(ds.caption_maps):
            texts = [normalize_caption(cmap[ds.caption_key(cap_id, k)],
                                       self.cfg.max_words)
                     for cap_id in ds.cap_ids]
            self.text_tokens.append(_encode_rows(self._encoder, texts,
                                                 max_len))
        self.caption_tokens: Dict[str, List[int]] = {}
        if self.cfg.generated_caption_type == "feats":
            self._feats_max_t = _feats_width(ds)
            return
        # one batch encode over the unique images
        uniq = list(dict.fromkeys(video_id_of(c) for c in ds.cap_ids))
        texts = [ds.generated[i] for i in uniq]
        if _is_clip_bpe(self.caption_tokenizer):  # 77 wide, padded with 0
            rows = [row.tolist() for row in
                    self.caption_tokenizer.encode(texts)]
        else:
            encoder = (self._encoder
                       if self.caption_tokenizer is self.tokenizer
                       else self.caption_tokenizer)
            rows = _encode_rows(encoder, texts, max_len)
        self.caption_tokens = dict(zip(uniq, rows))

    def steps_per_epoch(self) -> int:
        return len(self.dataset) // self.batch_size

    def epoch(self, epoch: int,
              start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """The batches of `epoch` from its batch `start_step` on (exact
        mid-epoch resume: the permutation is deterministic per epoch, and
        each batch's samples, crops and target language depend only on
        (epoch, its position)).  Decoding runs on a background thread
        pool; a sample that fails to load raises here."""
        idxs = shard_indices(len(self.dataset), epoch, self.cfg.seed,
                             shuffle=True, drop_last=True)
        nb = len(idxs) // self.batch_size
        idxs = idxs[: nb * self.batch_size].reshape(nb, self.batch_size)

        def produce(put):
            with ThreadPoolExecutor(self.num_workers) as pool:
                for step in range(start_step, nb):
                    batch_idx = idxs[step]
                    rngs = [np.random.RandomState(
                        (self.cfg.seed * 1000003 + epoch * 10007 + int(i))
                        % (2 ** 31)) for i in batch_idx]
                    samples = list(pool.map(
                        lambda a: self.dataset.get(int(a[0]), a[1]),
                        zip(batch_idx, rngs)))
                    if not put(self._collate(batch_idx, samples, step)):
                        return

        return background(produce, self.prefetch)

    def _collate(self, batch_idx, samples, step: int
                 ) -> Dict[str, np.ndarray]:
        buckets = self.cfg.token_buckets
        # several translated-target files: round-robin the target language
        # per batch (with two files it is always file 1)
        n_lang = len(self.text_tokens)
        k_t = 1 + (step % (n_lang - 1)) if n_lang > 1 else 0
        toks_s = [self.text_tokens[0][int(i)] for i in batch_idx]
        toks_t = [self.text_tokens[k_t][int(i)] for i in batch_idx]
        width = bucket_width(
            [len(t) for t in toks_s] + [len(t) for t in toks_t], buckets)
        ids_s, mask_s = pad_token_batch(toks_s, width)
        ids_t, mask_t = pad_token_batch(toks_t, width)

        batch: Dict[str, np.ndarray] = {
            "text_ids_s": ids_s, "text_mask_s": mask_s,
            "text_ids_t": ids_t, "text_mask_t": mask_t,
            "idx": np.asarray([s.idx for s in samples], np.int32),
        }
        if self.cfg.generated_caption_type == "feats":
            batch["caption_feats"], batch["caption_mask"] = _feats_batch(
                [s.caption for s in samples], self._feats_max_t)
        else:
            caps = [self.caption_tokens[video_id_of(s.cap_id)]
                    for s in samples]
            if _is_clip_bpe(self.caption_tokenizer):
                ids = np.asarray(caps, np.int32)
                batch["caption_ids"] = ids
                batch["caption_mask"] = (ids != 0).astype(np.int32)
            else:
                cwidth = bucket_width([len(c) for c in caps], buckets)
                batch["caption_ids"], batch["caption_mask"] = (
                    pad_token_batch(caps, cwidth))
        if samples[0].frames is None:
            batch["vision"] = np.stack([s.image_u8 for s in samples])
            batch["flip"] = np.asarray([s.flip for s in samples], bool)
        else:  # video: frames [B, T, Df] f32 and their valid mask [B, T]
            batch["vision"] = np.stack([s.frames for s in samples])
            batch["vision_mask"] = np.stack([s.frame_mask for s in samples])
        return batch


def _map_arrays(item, fn):
    """fn over every numpy array in a batch (a dict, or a tuple holding
    dicts and counts); anything else passes through."""
    if isinstance(item, np.ndarray):
        return fn(item)
    if isinstance(item, dict):
        return {k: _map_arrays(v, fn) for k, v in item.items()}
    if isinstance(item, tuple):
        return tuple(_map_arrays(v, fn) for v in item)
    return item


def _tensors(item) -> List[torch.Tensor]:
    if isinstance(item, torch.Tensor):
        return [item]
    if isinstance(item, dict):
        return [t for v in item.values() for t in _tensors(v)]
    if isinstance(item, tuple):
        return [t for v in item for t in _tensors(v)]
    return []


def device_prefetch(iterator: Iterable, device: torch.device,
                    depth: int = 2) -> Iterator:
    """The batches of `iterator` (dicts of numpy arrays, or tuples of such
    dicts and counts) as tensors on `device`.

    On a CUDA device a background thread pins each host batch and copies
    it with non_blocking=True on a side stream, `depth` batches ahead of
    the consumer, so the copies overlap the steps.  The consumer's stream
    waits for its batch's copy (an event recorded after it on the copy
    stream: a later batch's copy, queued since, is not waited for), and
    every tensor is marked used by the consumer's stream (record_stream),
    so the caching allocator does not hand its memory to the copy stream
    while a step still reads it.  An exception in `iterator` is raised in
    the consumer.  On the CPU it is a plain iteration."""
    device = torch.device(device)
    if device.type != "cuda":
        for item in iterator:
            yield _map_arrays(item, torch.from_numpy)
        return
    copy_stream = torch.cuda.Stream(device)

    def upload(item):
        # the pinned host copy may go once its copy is queued: the caching
        # host allocator holds the block until the copy has run
        with torch.cuda.stream(copy_stream):
            on_device = _map_arrays(item, lambda a: torch.from_numpy(
                np.ascontiguousarray(a)).pin_memory().to(
                    device, non_blocking=True))
            done = torch.cuda.Event()
            done.record(copy_stream)
        return on_device, done

    def produce(put):
        with torch.cuda.device(device):
            _drain_into(iterator, put, upload)

    for on_device, done in background(produce, depth):
        stream = torch.cuda.current_stream(device)
        stream.wait_event(done)
        for t in _tensors(on_device):
            t.record_stream(stream)
        yield on_device


class EvalLoader:
    """Eval batches: the split's texts, tokenized once and padded to the
    smallest token bucket covering its longest text, in chunks of
    `text_batch_size` (the last padded with empty rows), and image (or
    video frames + mask)/caption batches padded to `batch_size` by
    repeating the last row (surplus rows are sliced off after the
    forward)."""

    def __init__(self, dataset, tokenizer, cfg: DataConfig, batch_size: int,
                 text_batch_size: int, caption_tokenizer=None,
                 num_workers: int = 4):
        self.dataset = dataset
        self.tokenizer = tokenizer
        self.caption_tokenizer = caption_tokenizer or tokenizer
        self.cfg = cfg
        self.batch_size = batch_size
        self.text_batch_size = text_batch_size
        self.num_workers = max(1, num_workers)

    def text_batches(self):
        """(ids [T, W], mask [T, W], count) per chunk of the split."""
        texts = self.dataset.texts
        # the split is fixed: tokenize it once and cache on the dataset
        cache = getattr(self.dataset, "_tok_cache", None)
        if cache is None:
            ids_all, mask_all = self.tokenizer.encode(
                list(texts), self.cfg.max_tokens)
            longest = int(mask_all.sum(axis=1).max()) if len(texts) else 1
            width = next((b for b in sorted(self.cfg.token_buckets)
                          if b >= longest), self.cfg.max_tokens)
            ids_all = ids_all[:, :width]
            mask_all = mask_all[:, :width]
            self.dataset._tok_cache = (ids_all, mask_all)
        else:
            ids_all, mask_all = cache
        pad_rows = (-len(texts)) % self.text_batch_size
        if pad_rows:
            ids_all = np.pad(ids_all, ((0, pad_rows), (0, 0)))
            mask_all = np.pad(mask_all, ((0, pad_rows), (0, 0)))
        for i in range(0, len(texts), self.text_batch_size):
            n = min(self.text_batch_size, len(texts) - i)
            block = slice(i, i + self.text_batch_size)
            yield ids_all[block], mask_all[block], n

    def image_batches(self):
        """(batch dict, count) per chunk of the split's images; decoding
        runs in a thread pool."""
        n = len(self.dataset)
        feats_width = (_feats_width(self.dataset)
                       if self.cfg.generated_caption_type == "feats" else 0)
        with ThreadPoolExecutor(self.num_workers) as pool:
            for start in range(0, n, self.batch_size):
                stop = min(start + self.batch_size, n)
                count = stop - start
                rows = list(range(start, stop))
                rows += [rows[-1]] * (self.batch_size - count)
                items = list(pool.map(self.dataset.get, rows))
                caps = [it[1] for it in items]
                vision = [it[0] for it in items]
                if isinstance(vision[0], tuple):  # video: (frames, mask)
                    batch: Dict[str, np.ndarray] = {
                        "vision": np.stack([v[0] for v in vision]),
                        "vision_mask": np.stack([v[1] for v in vision])}
                else:
                    batch = {"vision": np.stack(vision)}
                if self.cfg.generated_caption_type == "feats":
                    batch["caption_feats"], batch["caption_mask"] = (
                        _feats_batch(caps, feats_width))
                elif _is_clip_bpe(self.caption_tokenizer):
                    ids = self.caption_tokenizer.encode(caps)
                    batch["caption_ids"] = ids
                    batch["caption_mask"] = (ids != 0).astype(np.int32)
                else:
                    batch["caption_ids"], batch["caption_mask"] = (
                        self.caption_tokenizer.encode(
                            caps, self.cfg.max_tokens))
                yield batch, count
