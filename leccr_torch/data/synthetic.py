"""Synthetic image datasets in the reference on-disk layout (the port's
own copy of the image half of `leccr_tpu/data/synthetic.py`).

Writes a miniature Multi30K-style or MSCOCO-style dataset — caption files,
id files, MLLM caption dir, JPEG images and a WordPiece vocab — so the full
parsing + pipeline + train/eval path runs end to end with no external
data.  At the same arguments the files are byte for byte the JAX
package's: the same RandomState draws in the same order.  The video
generator (MSR-VTT layout with a feature bank) comes with the video path
of the port."""

from __future__ import annotations

from pathlib import Path
from typing import List

import numpy as np

from leccr_torch.config import DataConfig
from leccr_torch.data.tokenizers import write_tiny_wordpiece_vocab

_WORDS_EN = ("a man rides his red bike near the old bridge while two dogs "
             "run across a green field and children play football by the "
             "river under a cloudy sky").split()
_WORDS_T = ("ein mann fährt sein rotes rad nahe der alten brücke während "
            "zwei hunde über ein grünes feld laufen und kinder am fluss "
            "fußball spielen").split()


def _sentence(rs: np.random.RandomState, words: List[str], n=8) -> str:
    return " ".join(rs.choice(words, size=n))


# --- learnable mode: concept-structured data so HELD-OUT retrieval can
# converge.  Pure-noise images with word-salad captions only support
# memorization, so eval sumR stays at chance forever; with one distinctive
# color per concept and captions dominated by that concept's word, a model
# that learns color<->word generalizes to unseen images and test sumR can
# approach its 600 ceiling (the recipe-level convergence check the
# reference gets implicitly from its 50-epoch eval loop,
# image_Retrieval_caption.py:441-504).
_CONCEPT_COLORS = np.array([
    [220, 40, 40], [40, 200, 40], [40, 80, 220], [230, 220, 50],
    [50, 220, 220], [220, 60, 220], [245, 150, 40], [245, 245, 245],
], np.uint8)


def _concept_image(rs: np.random.RandomState, concept: int,
                   image_res: int) -> np.ndarray:
    base = _CONCEPT_COLORS[concept % len(_CONCEPT_COLORS)].astype(np.int16)
    noise = rs.randint(-25, 26, (image_res, image_res, 3)).astype(np.int16)
    return np.clip(base[None, None] + noise, 0, 255).astype(np.uint8)


def _concept_sentence(rs: np.random.RandomState, concept: int,
                      words: List[str], n_filler: int = 3) -> str:
    # concept words must be mutually distinct AND disjoint from filler, or
    # a filler draw could make a caption look like ANOTHER concept's (the
    # word lists repeat articles — 'a'/'the', 'ein' — so enforce the
    # disjointness here rather than trusting the lists)
    n_c = len(_CONCEPT_COLORS)
    concept_word = words[concept % n_c]
    concept_set = set(words[:n_c])
    filler = [w for w in words[n_c:] if w not in concept_set]
    toks = [concept_word] * 3 + list(rs.choice(filler, size=n_filler))
    rs.shuffle(toks)
    return " ".join(toks)


def make_image_dataset(
    root: str,
    n_train: int = 32,
    n_eval: int = 8,
    caps_per_image: int = 2,
    image_res: int = 64,
    seed: int = 0,
    target_lang: str = "de",
    learnable: bool = False,
) -> DataConfig:
    """Create the dataset and return a DataConfig pointing at it.

    ``learnable=True`` structures the data so held-out retrieval converges:
    image i carries concept ``i % 8`` as a distinctive color, and all its
    captions are dominated by that concept's word (see _concept_sentence).
    With ``n_eval == 8`` every eval image has a unique concept, so perfect
    concept learning = perfect retrieval (test sumR -> 600)."""
    rs = np.random.RandomState(seed)
    root = Path(root)
    (root / "img_id").mkdir(parents=True, exist_ok=True)
    (root / "TextData").mkdir(exist_ok=True)
    (root / "images").mkdir(exist_ok=True)
    (root / "caption").mkdir(exist_ok=True)

    from PIL import Image

    def write_split(name: str, ids: List[str], id_file: str):
        lines_en, lines_t = [], []
        for i, img in enumerate(ids):
            if learnable:
                arr = _concept_image(rs, i, image_res)
                gen = _concept_sentence(rs, i, _WORDS_EN, 5)
            else:
                arr = rs.randint(0, 255, (image_res, image_res, 3), np.uint8)
                gen = _sentence(rs, _WORDS_EN, 10)
            Image.fromarray(arr).save(root / "images" / f"{img}.jpg")
            (root / "caption" / f"{img}.txt").write_text(gen)
            for c in range(caps_per_image):
                en = (_concept_sentence(rs, i, _WORDS_EN) if learnable
                      else _sentence(rs, _WORDS_EN))
                tt = (_concept_sentence(rs, i, _WORDS_T) if learnable
                      else _sentence(rs, _WORDS_T))
                lines_en.append(f"{img}#enc#{c} {en}")
                lines_t.append(f"{img}#enc2{target_lang}#{c} {tt}")
        (root / "TextData" / f"{name}_enc.caption.txt").write_text(
            "\n".join(lines_en))
        (root / "TextData" / f"{name}_enc2{target_lang}.caption.txt"
         ).write_text("\n".join(lines_t))
        (root / "img_id" / id_file).write_text("\n".join(ids))

    train_ids = [f"img{i:04d}" for i in range(n_train)]
    val_ids = [f"val{i:04d}" for i in range(n_eval)]
    test_ids = [f"tst{i:04d}" for i in range(n_eval)]
    write_split("train", train_ids, "train_id.txt")
    write_split("val", val_ids, "val_id.txt")
    write_split("test", test_ids, "test_id_2016.txt")

    write_tiny_wordpiece_vocab(
        str(root / "vocab.txt"), _WORDS_EN + _WORDS_T)

    return DataConfig(
        dataset="multi30k",
        root_dir=str(root),
        train_file=["TextData/train_enc.caption.txt",
                    f"TextData/train_enc2{target_lang}.caption.txt"],
        val_file={target_lang: "TextData/val_enc.caption.txt"},
        test_file={target_lang: "TextData/test_enc.caption.txt"},
        image_root=str(root / "images"),
        generated_caption_dir=str(root / "caption"),
        max_tokens=24,
        token_buckets=[16, 24],
        text_vocab=str(root / "vocab.txt"),
        num_workers=2,
    )


def make_mscoco_dataset(
    root: str,
    n_train: int = 8,
    n_eval: int = 4,
    caps_per_image: int = 2,
    image_res: int = 32,
    seed: int = 0,
    target_lang: str = "zh",
) -> DataConfig:
    """MSCOCO-layout variant: numeric image ids indirected through
    `img_id/image_ids.txt` (reference retrieval_dataset.py:47-54,117-122)
    and per-language eval id files `{lang}_{val,test}_id.txt`."""
    rs = np.random.RandomState(seed)
    root = Path(root)
    (root / "img_id").mkdir(parents=True, exist_ok=True)
    (root / "TextData").mkdir(exist_ok=True)
    (root / "images").mkdir(exist_ok=True)
    (root / "caption").mkdir(exist_ok=True)

    from PIL import Image

    name_map = {}

    def write_split(name, ids, id_file):
        lines_en, lines_t = [], []
        for img in ids:
            fname = f"COCO_train2014_{img}.jpg"
            name_map[img] = fname
            arr = rs.randint(0, 255, (image_res, image_res, 3), np.uint8)
            Image.fromarray(arr).save(root / "images" / fname)
            (root / "caption" / f"COCO_train2014_{img}.txt").write_text(
                _sentence(rs, _WORDS_EN, 10))
            for c in range(caps_per_image):
                lines_en.append(f"{img}#enc#{c} {_sentence(rs, _WORDS_EN)}")
                lines_t.append(
                    f"{img}#enc2{target_lang}#{c} "
                    f"{_sentence(rs, _WORDS_T)}")
        (root / "TextData" / f"{name}_enc.caption.txt").write_text(
            "\n".join(lines_en))
        (root / "TextData" / f"{name}_enc2{target_lang}.caption.txt"
         ).write_text("\n".join(lines_t))
        (root / "img_id" / id_file).write_text("\n".join(ids))

    def write_eval_split(stem, ids, id_file):
        # reference naming: cocoval_zh.caption.txt → language parsed from
        # the last underscore token (retrieval_dataset.py:164)
        lines = []
        for img in ids:
            fname = f"COCO_val2014_{img}.jpg"
            name_map[img] = fname
            arr = rs.randint(0, 255, (image_res, image_res, 3), np.uint8)
            Image.fromarray(arr).save(root / "images" / fname)
            (root / "caption" / f"COCO_val2014_{img}.txt").write_text(
                _sentence(rs, _WORDS_EN, 10))
            for c in range(caps_per_image):
                lines.append(f"{img}#enc#{c} {_sentence(rs, _WORDS_T)}")
        (root / "TextData" / f"{stem}_{target_lang}.caption.txt"
         ).write_text("\n".join(lines))
        (root / "img_id" / id_file).write_text("\n".join(ids))

    train_ids = [f"{100000 + i}" for i in range(n_train)]
    val_ids = [f"{200000 + i}" for i in range(n_eval)]
    test_ids = [f"{300000 + i}" for i in range(n_eval)]
    write_split("train", train_ids, "train_id.txt")
    # mscoco eval id files are per-language (retrieval_dataset.py:164-165)
    write_eval_split("cocoval", val_ids, f"{target_lang}_val_id.txt")
    write_eval_split("cocotest", test_ids, f"{target_lang}_test_id.txt")
    (root / "img_id" / "image_ids.txt").write_text(
        "\n".join(f"{k} {v}" for k, v in name_map.items()))

    write_tiny_wordpiece_vocab(str(root / "vocab.txt"),
                               _WORDS_EN + _WORDS_T)
    return DataConfig(
        dataset="mscoco",
        root_dir=str(root),
        train_file=["TextData/train_enc.caption.txt",
                    f"TextData/train_enc2{target_lang}.caption.txt"],
        val_file={target_lang:
                  f"TextData/cocoval_{target_lang}.caption.txt"},
        test_file={target_lang:
                   f"TextData/cocotest_{target_lang}.caption.txt"},
        image_root=str(root / "images"),
        generated_caption_dir=str(root / "caption"),
        max_tokens=24,
        token_buckets=[16, 24],
        text_vocab=str(root / "vocab.txt"),
        num_workers=2,
    )
