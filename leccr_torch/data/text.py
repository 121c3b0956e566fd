"""Caption-file parsing and text normalization (the port's own copy of
`leccr_tpu/data/text.py`, which it does not import).

Capability parity with the reference dataset layer (SURVEY.md §2 #10):
- caption files are lines of `cap_id caption` where cap_id is
  `imgid#enc#n` / `imgid#enc2fr#n` (reference retrieval_dataset.py:88-94);
- `video_id_of` strips the `#...` suffix and a `.jpg`/`.mp4` extension
  (reference `getVideoId`, retrieval_dataset.py:21-25);
- `normalize_caption` reproduces `pre_caption` (dataset/utils.py:31-59):
  punctuation→space, lowercase, dash/slash→space, <person>→person,
  whitespace squeeze, word-level truncation;
- `build_eval_index` reproduces the txt2img/img2txt ground-truth maps
  (retrieval_dataset.py:208-226): images are numbered in first-appearance
  order, texts keep file order.
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

_PUNCT = re.compile(r"([,.'!?\"()*#:;~])")
_SPACES = re.compile(r"\s{2,}")


def normalize_caption(caption: str, max_words: int = 30) -> str:
    """pre_caption-equivalent normalization (dataset/utils.py:31-59)."""
    out = _PUNCT.sub(" ", caption.lower())
    out = out.replace("-", " ").replace("/", " ").replace("<person>", "person")
    out = _SPACES.sub(" ", out)
    out = out.rstrip("\n").strip(" ")
    words = out.split(" ")
    if len(words) > max_words:
        out = " ".join(words[:max_words])
    if not out:
        raise ValueError(f"caption normalized to empty (raw: {caption!r})")
    return out


def video_id_of(cap_id: str) -> str:
    """`imgid#enc#0` -> `imgid`, stripping .jpg/.mp4."""
    vid = cap_id.split("#")[0]
    if vid.endswith(".jpg") or vid.endswith(".mp4"):
        vid = vid[:-4]
    return vid


def language_of_train_file(path: str) -> str:
    """Extract the target language from a translated-caption filename,
    e.g. `Flickr30ktrain_google_enc2fr.caption.txt` -> `fr`
    (reference retrieval_dataset.py:82-84)."""
    stem = path.rsplit("/", 1)[-1].split(".", 1)[0]
    return stem.split("2", 1)[-1]


def parse_caption_file(path: str) -> List[Tuple[str, str]]:
    """Read `cap_id caption` lines -> [(cap_id, caption), ...]."""
    out = []
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line:
            continue
        cap_id, caption = line.split(" ", 1)
        out.append((cap_id, caption))
    return out


def read_id_file(path: str) -> List[str]:
    return [ln.strip("\n") for ln in Path(path).read_text().splitlines()
            if ln.strip("\n")]


@dataclasses.dataclass
class EvalIndex:
    """Ground truth for one eval split."""

    texts: List[str]  # normalized captions, file order
    image_ids: List[str]  # first-appearance order
    txt2img: Dict[int, int]
    img2txt: Dict[int, List[int]]
    cap_ids: List[str]


def build_eval_index(
    entries: Sequence[Tuple[str, str]], max_words: int = 30
) -> EvalIndex:
    """Build txt2img/img2txt exactly like the reference eval dataset
    (retrieval_dataset.py:208-226)."""
    texts: List[str] = []
    image_ids: List[str] = []
    seen: Dict[str, int] = {}
    txt2img: Dict[int, int] = {}
    img2txt: Dict[int, List[int]] = {}
    cap_ids: List[str] = []
    for txt_id, (cap_id, caption) in enumerate(entries):
        image_id = video_id_of(cap_id)
        if image_id in seen:
            img_id = seen[image_id]
        else:
            img_id = len(image_ids)
            seen[image_id] = img_id
            image_ids.append(image_id)
        texts.append(normalize_caption(caption, max_words))
        img2txt.setdefault(img_id, []).append(txt_id)
        txt2img[txt_id] = img_id
        cap_ids.append(cap_id)
    return EvalIndex(texts, image_ids, txt2img, img2txt, cap_ids)


def read_generated_captions(
    caption_dir: str, image_ids: Sequence[str],
    name_map: Dict[str, str] | None = None,
) -> Dict[str, str]:
    """Load per-image MLLM captions `<caption_dir>/<id>.txt`
    (reference retrieval_dataset.py:59-79).  name_map handles the mscoco
    id -> filename indirection (image_ids.txt)."""
    out = {}
    for image_id in image_ids:
        name = image_id
        if name_map is not None:
            name = name_map[image_id]
            if name.endswith(".jpg"):
                name = name[:-4]
        out[image_id] = Path(
            caption_dir, f"{name}.txt").read_text().strip("\n")
    return out


def read_image_name_map(path: str) -> Dict[str, str]:
    """mscoco `image_ids.txt`: lines of `id filename`
    (reference retrieval_dataset.py:47-54)."""
    out = {}
    for line in Path(path).read_text().splitlines():
        line = line.strip("\n")
        if not line:
            continue
        key, name = line.split(" ", 1)
        out[key] = name
    return out
