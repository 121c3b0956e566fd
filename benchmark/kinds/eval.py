"""Traffic of kind "eval": complete evals back to back: `embed_texts` over
the texts, `embed_images` over the images with their captions,
`retrieval_ranks` and `itm_metrics_from_ranks`.

The mix gives one Multi30K-style test split: "images" images with one
MLLM caption each ("caption_tokens" real tokens, padded to the
configuration's max_tokens) and "captions_per_image" texts per image
("text_tokens" real tokens, padded to the smallest bucket that holds the
longest, as the eval loader pads them); "warmup_evals" and "trace_at".

What is compared (`compare_eval`): the window's last eval, its features
against the reference's, its ranks and metrics against the reference's
ranking of the program's own features.
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import Dict

import numpy as np
import torch

from benchmark import drivers, generator
from benchmark.reference import retrieval as ref_retrieval
from benchmark.reference.model import Model, Precision
from benchmark.tracing import Slice
from benchmark.weights import stream_seed

TEST_SIZE = {"images": 6}


def inputs(mix: dict, cfg, seed: int, device) -> list:
    """[one test split]: "images" uint8, "caption_ids"/"caption_mask",
    "text_ids"/"text_mask", "txt2img" [T] and "img2txt" [N, k] (numpy)."""
    n, per = mix["images"], mix["captions_per_image"]
    vocab = cfg.model.text.vocab_size
    host = np.random.default_rng(stream_seed(seed, 4))
    g = torch.Generator(device=device).manual_seed(stream_seed(seed, 5))
    len_c = generator.lengths(host, mix["caption_tokens"], n)
    len_t = generator.lengths(host, mix["text_tokens"], n * per)
    longest = int(len_t.max())
    width = next((b for b in sorted(cfg.data.token_buckets) if b >= longest),
                 cfg.data.max_tokens)
    images = generator.images(g, n, cfg.model.vision.image_res, device)
    cap_ids, cap_mask = generator.tokens(g, len_c, cfg.data.max_tokens,
                                         vocab, device)
    txt_ids, txt_mask = generator.tokens(g, len_t, width, vocab, device)
    return [{"images": images, "caption_ids": cap_ids,
             "caption_mask": cap_mask, "text_ids": txt_ids,
             "text_mask": txt_mask,
             "txt2img": np.arange(n * per) // per,
             "img2txt": np.arange(n * per).reshape(n, per)}]


class Driver(drivers.Driver):
    program_state = ("model",)

    def setup(self) -> None:
        self.model = self._model()
        self.split = inputs(self.mix, self.cfg, self.seed, self.device)[0]
        for _ in range(self.mix.get("warmup_evals", 1)):
            self._eval()
            self.beat()

    def _batches(self, n: int, size: int):
        """(rows of a full batch, real count): the last batch repeats its
        last row up to the batch size, as the eval loader pads it."""
        for start in range(0, n, size):
            count = min(size, n - start)
            rows = torch.arange(start, start + size, device=self.device)
            yield rows.clamp_max(n - 1), count

    def _eval(self):
        from leccr_torch.data.images import normalize_images
        from leccr_torch.eval.retrieval import (
            itm_metrics_from_ranks,
            retrieval_ranks,
        )

        s, m = self.split, self.model
        tb, ib = self.cfg.train.batch_size_test_text, \
            self.cfg.train.batch_size_test
        txt = torch.cat([m.embed_texts(s["text_ids"][r], s["text_mask"][r])[:c]
                         for r, c in self._batches(len(s["text_ids"]), tb)])
        img = torch.cat([m.embed_images({
            "vision": normalize_images(s["images"][r]),
            "caption_ids": s["caption_ids"][r],
            "caption_mask": s["caption_mask"][r]})["feat"][:c]
            for r, c in self._batches(len(s["images"]), ib)])
        i2t, t2i = retrieval_ranks(img, txt, s["txt2img"], s["img2txt"])
        return img, txt, i2t, t2i, itm_metrics_from_ranks(i2t, t2i)

    def window(self, seconds: float, traced: bool) -> dict:
        trace_at = seconds * self.mix.get("trace_at", 0.3)
        n, done_trace = 0, not traced
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            if not done_trace and time.perf_counter() - t0 >= trace_at:
                with Slice() as sl:
                    before = drivers.counters()
                    self.out = self._eval()
                    launches = drivers.diff(drivers.counters(), before)
                with Slice(host=True) as named:
                    self.out = self._eval()
                n += 1
                self.trace = drivers.traced(sl, named, launches=launches)
                done_trace = True
            else:
                self.out = self._eval()
            n += 1
            self.beat()
        t1 = time.perf_counter()
        self.attempted = n
        self.failed = int(len(self.out[4]) != 13 or not all(
            math.isfinite(v) for v in self.out[4].values()))
        return {"eval_s": (t1 - t0) / n}

    def _embed(self, model: Model):
        """(image features, text features) of the reference `model`."""
        s = self.split
        tb, ib = self.cfg.train.batch_size_test_text, \
            self.cfg.train.batch_size_test
        txt = torch.cat([
            model.embed_texts(s["text_ids"][r], s["text_mask"][r])[:c]
            for r, c in self._batches(len(s["text_ids"]), tb)])
        img = torch.cat([
            model.embed_images(s["images"][r], s["caption_ids"][r],
                               s["caption_mask"][r])[:c]
            for r, c in self._batches(len(s["images"]), ib)])
        return img, txt

    def check(self) -> Dict[str, tuple]:
        img, txt, i2t, t2i, got_metrics = self.out
        s = self.split
        want_img, want_txt = self._embed(Model(self._weights(), self.arch))
        r_i2t, r_t2i = ref_retrieval.ranks(img, txt, s["txt2img"],
                                           s["img2txt"])
        want_metrics = ref_retrieval.metrics(r_i2t, r_t2i)
        return compare_eval(img, txt, want_img, want_txt,
                            (i2t, t2i), (r_i2t, r_t2i), got_metrics,
                            want_metrics)

    def readings(self, control: bool) -> dict:
        """The program's numbers of one complete eval, and the fp8
        control's features in its place against the f32 reference's."""
        self.out = self._eval()
        self.release()
        out = {"program": drivers.values(self.check())}
        if control:
            s = self.split
            img, txt = self._embed(Model(self._weights(), self.arch,
                                         Precision(fp8=True)))
            want_img, want_txt = self._embed(Model(self._weights(),
                                                   self.arch))
            ranks = ref_retrieval.ranks(img, txt, s["txt2img"], s["img2txt"])
            metrics = ref_retrieval.metrics(*ranks)
            out["control"] = drivers.values(compare_eval(
                img, txt, want_img, want_txt, ranks, ranks, metrics,
                metrics))
        return out


def compare_eval(img, txt, want_img, want_txt, ranks, want_ranks,
                 got_metrics, want_metrics) -> Dict[str, tuple]:
    def worst_row(got, want):
        d = torch.linalg.vector_norm(got.float() - want.float(), dim=1)
        return float(d.max()), int(d.argmax())

    gi, ri = worst_row(img, want_img)
    gt, rt = worst_row(txt, want_txt)
    rank_diff = int(sum(np.sum(np.asarray(a) != np.asarray(b))
                        for a, b in zip(ranks, want_ranks)))
    metric_diff = sum(got_metrics.get(k) != v
                      for k, v in want_metrics.items()) + len(
        set(got_metrics) ^ set(want_metrics))
    return {"image_feat_gap": (gi, f"worst image row {ri}"),
            "text_feat_gap": (gt, f"worst text row {rt}"),
            "rank_mismatches": (float(rank_diff),
                                "ranks against the reference's ranking of "
                                "the program's features"),
            "metric_mismatches": (float(metric_diff),
                                  "of the 13 Recall@K keys")}


@contextlib.contextmanager
def altered_answer():
    """`embed_texts` returns its first row negated."""
    from leccr_torch.models.leccr import LECCRModel

    original = LECCRModel.embed_texts

    def altered(self, ids, mask):
        out = original(self, ids, mask).clone()
        out[0] = -out[0]
        return out

    LECCRModel.embed_texts = altered
    try:
        yield
    finally:
        LECCRModel.embed_texts = original


FAULTS = (altered_answer,)
