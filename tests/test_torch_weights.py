"""Checkpoint import into the port (leccr_torch.models.convert and
models.weights) against the JAX package's on the same files: the text
converters through params_from_jax, key for key and bit for bit;
load_initial_checkpoint on each flavor (a reference .pth, an OpenAI
archive saved with torch.jit and plain, HF BERT and XLM-R as .bin and
.safetensors with each key prefix, the port's own checkpoint), with the
same parameters as the JAX result (the resampled position table within
tests/test_torch_hires_step.py's 1e-5) and the same grafted and issue
lists; orbax directories refused; the safetensors reader."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import leccr_torch.models.clip as tclip
import leccr_tpu.models.clip as jclip
import leccr_tpu.models.weights as jweights
from leccr_torch.config import tiny_test_config as torch_tiny_config
from leccr_torch.models import convert as tconvert
from leccr_torch.models import weights as tweights
from leccr_torch.models.leccr import LECCRModel as TorchLECCR
from leccr_torch.models.weights import (
    flax_to_state_dict,
    load_initial_checkpoint,
    load_jax_params,
    params_from_jax,
)
from leccr_torch.train.checkpoints import CheckpointManager
from leccr_tpu.config import tiny_test_config
from leccr_tpu.models import convert as jconvert
from leccr_tpu.models.leccr import LECCRModel

POS_ATOL = 1e-5  # tests/test_torch_hires_step.py:206
POS = "vision_tower.positional_embedding"
DEAD = {"itm_head.weight": (2, 64), "itm_head.bias": (2,),
        "clip_encoder.logit_scale": ()}


@pytest.fixture(autouse=True)
def tiny_variant(monkeypatch):
    """ViT width 64 at patch 32 (grid 2 at 64²) with a 48-wide text tower."""
    for mod in (jclip, tclip):
        monkeypatch.setitem(mod.CLIP_VARIANTS, "tiny/32", mod.CLIPVariant(
            64, 2, 2, 32, 64, 48, 2, 4, vocab_size=600, context_length=77))


def _rand(rs, *shape, scale=0.1):
    return torch.from_numpy((scale * rs.randn(*shape)).astype(np.float32))


def _clip_sd(rs, grid=3, vision_layers=3, w=64, tw=48):
    """An OpenAI-layout CLIP state_dict: `visual.*` at a grid × grid patch
    grid and one more vision layer than the tiny tower has, and the text
    transformer."""
    sd = {"visual.conv1.weight": _rand(rs, w, 3, 32, 32),
          "visual.class_embedding": _rand(rs, w),
          "visual.positional_embedding": _rand(rs, grid * grid + 1, w),
          "visual.proj": _rand(rs, w, 64),
          "logit_scale": torch.tensor(4.6)}

    def blocks(prefix, width, n):
        for i in range(n):
            b = f"{prefix}.resblocks.{i}"
            sd[f"{b}.attn.in_proj_weight"] = _rand(rs, 3 * width, width)
            sd[f"{b}.attn.in_proj_bias"] = _rand(rs, 3 * width)
            for name, (o, k) in {"attn.out_proj": (width, width),
                                 "mlp.c_fc": (4 * width, width),
                                 "mlp.c_proj": (width, 4 * width)}.items():
                sd[f"{b}.{name}.weight"] = _rand(rs, o, k)
                sd[f"{b}.{name}.bias"] = _rand(rs, o)
            for ln in ("ln_1", "ln_2"):
                sd[f"{b}.{ln}.weight"] = 1 + _rand(rs, width)
                sd[f"{b}.{ln}.bias"] = _rand(rs, width)

    for ln in ("ln_pre", "ln_post"):
        sd[f"visual.{ln}.weight"] = 1 + _rand(rs, w)
        sd[f"visual.{ln}.bias"] = _rand(rs, w)
    blocks("visual.transformer", w, vision_layers)
    sd["token_embedding.weight"] = _rand(rs, 600, tw)
    sd["positional_embedding"] = _rand(rs, 77, tw)
    sd["text_projection"] = _rand(rs, tw, 64)
    sd["ln_final.weight"] = 1 + _rand(rs, tw)
    sd["ln_final.bias"] = _rand(rs, tw)
    blocks("transformer", tw, 2)
    return sd


def _hf_clip_text_sd(rs, tw=48, layers=2):
    sd = {"text_model.embeddings.token_embedding.weight": _rand(rs, 600, tw),
          "text_model.embeddings.position_embedding.weight": _rand(rs, 77, tw),
          "text_model.final_layer_norm.weight": 1 + _rand(rs, tw),
          "text_model.final_layer_norm.bias": _rand(rs, tw),
          "text_projection.weight": _rand(rs, 64, tw)}
    for i in range(layers):
        b = f"text_model.encoder.layers.{i}"
        for name, (o, k) in {"self_attn.q_proj": (tw, tw),
                             "self_attn.k_proj": (tw, tw),
                             "self_attn.v_proj": (tw, tw),
                             "self_attn.out_proj": (tw, tw),
                             "mlp.fc1": (4 * tw, tw),
                             "mlp.fc2": (tw, 4 * tw)}.items():
            sd[f"{b}.{name}.weight"] = _rand(rs, o, k)
            sd[f"{b}.{name}.bias"] = _rand(rs, o)
        for ln in ("layer_norm1", "layer_norm2"):
            sd[f"{b}.{ln}.weight"] = 1 + _rand(rs, tw)
            sd[f"{b}.{ln}.bias"] = _rand(rs, tw)
    return sd


def _hf_text(kind, seed=2):
    """A tiny HF BertModel or XLMRobertaModel with a 128-row vocabulary."""
    import transformers

    torch.manual_seed(seed)
    common = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
                  num_attention_heads=4, intermediate_size=128)
    if kind == "bert":
        return transformers.BertModel(transformers.BertConfig(
            max_position_embeddings=64, **common))
    return transformers.XLMRobertaModel(transformers.XLMRobertaConfig(
        max_position_embeddings=66, type_vocab_size=1, pad_token_id=1,
        **common))


def _assert_sd_equal(got, want, pos_atol=0.0):
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        atol = pos_atol if name.endswith("positional_embedding") else 0.0
        torch.testing.assert_close(got[name], value, rtol=0, atol=atol,
                                   msg=name)


# ---------------------------------------------------------- converters


def test_clip_text_converters_equal_jax():
    rs = np.random.RandomState(0)
    sd = _clip_sd(rs)
    _assert_sd_equal(tconvert.clip_text_state_dict(sd, 2),
                     flax_to_state_dict(jconvert.clip_text_params(sd, 2)))
    hf = _hf_clip_text_sd(rs)
    _assert_sd_equal(
        tconvert.clip_text_state_dict_from_hf(hf, 2),
        flax_to_state_dict(jconvert.clip_text_params_from_hf(hf, 2)))
    del hf["text_projection.weight"]  # no projection head: the identity
    _assert_sd_equal(
        tconvert.clip_text_state_dict_from_hf(hf, 2),
        flax_to_state_dict(jconvert.clip_text_params_from_hf(hf, 2)))


@pytest.mark.parametrize("kind,prefix", [
    ("bert", ""), ("bert", "bert."), ("xlmr", ""), ("xlmr", "roberta.")])
def test_bert_converter_equals_jax(kind, prefix):
    sd = {prefix + k: v for k, v in _hf_text(kind).state_dict().items()}
    _assert_sd_equal(tconvert.bert_state_dict(sd, 2, prefix),
                     flax_to_state_dict(jconvert.bert_params(sd, 2, prefix)))


def test_mha_converter_equals_jax():
    torch.manual_seed(3)
    mha = nn.MultiheadAttention(64, 4).state_dict()
    _assert_sd_equal(tconvert.mha_state_dict_from_torch(mha, 64),
                     flax_to_state_dict(jconvert.mha_params_from_torch(
                         mha, 64)))


class _Holder(nn.Module):
    """A module tree holding a flat state_dict under its dotted names (for
    TorchScript archives and pickled modules)."""

    def __init__(self, sd=None):
        super().__init__()
        for key, value in (sd or {}).items():
            node = self
            *path, leaf = key.split(".")
            for part in path:
                if not hasattr(node, part):
                    node.add_module(part, _Holder())
                node = getattr(node, part)
            node.register_parameter(leaf, nn.Parameter(value.clone()))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


@pytest.mark.parametrize("layout", ["jit", "plain", "model", "module"])
def test_load_torch_state_dict_equals_jax(tmp_path, layout):
    sd = _clip_sd(np.random.RandomState(4))
    path = str(tmp_path / "ckpt.pt")
    if layout == "jit":
        torch.jit.save(torch.jit.script(_Holder(sd)), path)
    else:
        obj = {"plain": sd, "model": {"model": sd, "epoch": 3},
               "module": _Holder(sd)}[layout]
        torch.save(obj, path)
    got = tconvert.load_torch_state_dict(path)
    want = jconvert.load_torch_state_dict(path)
    assert sorted(got) == sorted(want) == sorted(sd)
    for key in sd:
        assert torch.equal(got[key], want[key]) and torch.equal(
            got[key], sd[key])


def test_safetensors_reader_equals_the_library(tmp_path):
    st = pytest.importorskip("safetensors.numpy")
    import safetensors.torch

    rs = np.random.RandomState(5)
    tensors = {"w": torch.from_numpy(rs.randn(3, 5).astype(np.float32)),
               "h": torch.from_numpy(rs.randn(4).astype(np.float16)),
               "b": torch.from_numpy(rs.randn(2, 2)).to(torch.bfloat16),
               "i": torch.arange(7), "e": torch.zeros(0, 3),
               "s": torch.tensor(2.5)}
    path = str(tmp_path / "t.safetensors")
    safetensors.torch.save_file(tensors, path, metadata={"format": "pt"})
    got = tconvert.load_safetensors(path)
    assert sorted(got) == sorted(tensors)
    for key, value in tensors.items():
        assert got[key].dtype == value.dtype and torch.equal(got[key], value)
    for key, value in st.load_file(path).items():  # numpy has no bf16
        if key != "b":
            np.testing.assert_array_equal(got[key].numpy(), value)


# ------------------------------------------------------ whole-model import


def _overrides(caption="mbert", text="mbert"):
    out = {"model.vision.variant": "tiny/32",
           "model.caption_encoder_name": caption}
    if text == "xlmr":
        out.update({"model.text.kind": "xlmr", "model.text.vocab_size": 128,
                    "model.text.max_position_embeddings": 66,
                    "model.text.type_vocab_size": 1,
                    "model.text.pad_token_id": 1})
    return out


def _cfgs(**kw):
    """(the JAX package's config, the port's) with the same fields."""
    return (tiny_test_config(**_overrides(**kw)),
            torch_tiny_config(**_overrides(**kw)))


def _port_cfg(**kw):
    return torch_tiny_config(**_overrides(**kw))


def _init(cfgs, seed=0):
    """The JAX model's params at `seed` (moved off the init) and a port
    model holding the same values."""
    cfg, port_cfg = cfgs
    model = LECCRModel(cfg.model)
    rs = np.random.RandomState(seed)
    res = cfg.model.vision.image_res
    ids = rs.randint(2, 100, (1, 8)).astype(np.int32)
    batch = {"vision": np.zeros((1, res, res, 3), np.float32),
             "text_ids_s": ids, "text_mask_s": np.ones_like(ids),
             "text_ids_t": ids, "text_mask_t": np.ones_like(ids),
             "caption_ids": ids, "caption_mask": np.ones_like(ids)}
    params = model.init({"params": jax.random.PRNGKey(seed)},
                        jax.tree.map(jnp.asarray, batch))["params"]
    params = jax.tree.map(
        lambda x: np.asarray(x + 0.05 * rs.randn(*np.shape(x)), np.float32),
        params)
    port = TorchLECCR(port_cfg.model, device="cpu", seed=seed)
    load_jax_params(port, params)
    return params, port


def _jax_name(path, prefix):
    parts = []
    for part in path.split("/"):
        m = re.match(r"^(layer|resblock)_(\d+)$", part)
        parts += [m.group(1) + "s", m.group(2)] if m else [part]
    if parts[-1] in ("kernel", "scale", "embedding"):
        parts[-1] = "weight"
    return prefix + ".".join(parts)


_PREFIX = {"CLIP vision": "vision_tower.", "ref ckpt vision": "vision_tower.",
           "CLIP text": "clip_text_tower.",
           "ref ckpt clip text": "clip_text_tower.",
           "BERT": "text_encoder.", "ref ckpt text": "text_encoder.",
           "ref ckpt head": ""}


def _issue_key(issue):
    kind, rest = issue.split(": ", 1)
    return kind, rest.split(" ")[0]


def _import_both(monkeypatch, cfgs, path, jax_load=None):
    """JAX's and the port's import of `path` into the same initial
    weights: (port model, JAX result as a state_dict, port report, JAX's
    (grafted, issues) per _graft call)."""
    cfg = cfgs[0]
    params, port = _init(cfgs)
    calls = []
    graft = jweights._graft

    def recorded(dst, src, path=""):
        g, b = graft(dst, src, path)
        if not path:
            calls.append((g, b))
        return g, b

    monkeypatch.setattr(jweights, "_graft", recorded)
    load = jax_load or (lambda p: jweights.load_initial_checkpoint(
        p, params, cfg))
    want = params_from_jax(jax.tree.map(np.asarray, load(str(path))),
                           port.cfg)
    report = load_initial_checkpoint(str(path), port)
    return port, want, report, calls


def _check(port, want, report, calls):
    got = port.state_dict()
    _assert_sd_equal(got, want, pos_atol=POS_ATOL)
    assert len(report.sections) == len(calls)
    for (label, grafted, issues), (g, b) in zip(report.sections, calls):
        prefix = _PREFIX[label]
        assert sorted(grafted) == sorted(_jax_name(n, prefix) for n in g)
        assert sorted(map(_issue_key, issues)) == sorted(
            (kind, _jax_name(name, prefix))
            for kind, name in map(_issue_key, b))


@pytest.mark.parametrize("caption", ["mbert", "clip"])
def test_reference_checkpoint_import_equals_jax(tmp_path, monkeypatch,
                                                caption, capsys):
    """A reference-format .pth (the JAX export of other weights, at the
    model's own grid, plus dead X-VLM keys)."""
    cfgs = _cfgs(caption=caption)
    other, _ = _init(cfgs, seed=7)
    sd = jweights.export_reference_state_dict(other, cfgs[0])
    sd = {k: torch.tensor(np.asarray(v)) for k, v in sd.items()}
    sd.update({k: torch.ones(s) for k, s in DEAD.items()})
    path = tmp_path / "checkpoint_best.pth"
    torch.save({"model": sd, "epoch": 9}, path)
    port, want, report, calls = _import_both(monkeypatch, cfgs, path)
    _check(port, want, report, calls)
    assert report.flavor == "reference"
    assert sorted(report.unused) == sorted(DEAD)
    assert all(f"unused: {k}" in report.issues for k in DEAD)
    assert not [i for _, _, b in report.sections for i in b]
    # every live parameter came from the file
    assert sorted(report.grafted) == sorted(port.state_dict())
    assert "### ref ckpt head:" in capsys.readouterr().out


@pytest.mark.parametrize("saved", ["jit", "plain"])
@pytest.mark.parametrize("caption", ["mbert", "clip"])
def test_openai_archive_import_equals_jax(tmp_path, monkeypatch, saved,
                                          caption):
    """A 3 × 3-grid, 3-layer OpenAI archive into the 2 × 2-grid, 2-layer
    tower: the position table resampled, the third layer unexpected; the
    text tower into the CLIP caption encoder."""
    cfgs = _cfgs(caption=caption)
    sd = _clip_sd(np.random.RandomState(8))
    path = tmp_path / "ViT-tiny.pt"
    if saved == "jit":
        torch.jit.save(torch.jit.script(_Holder(sd)), str(path))
    else:
        torch.save(sd, path)
    port, want, report, calls = _import_both(monkeypatch, cfgs, path)
    _check(port, want, report, calls)
    assert report.flavor == "openai"
    assert "unexpected: vision_tower.transformer.resblocks.2" in report.issues
    want_pos = tclip.interpolate_pos_embed(sd["visual.positional_embedding"],
                                           2)
    torch.testing.assert_close(port.state_dict()[POS], want_pos, rtol=0,
                               atol=0)
    unused = {"logit_scale"} | ({k for k in sd if not k.startswith("visual.")
                                 and k != "logit_scale"}
                                if caption == "mbert" else set())
    assert set(report.unused) == unused


@pytest.mark.parametrize("fmt", ["bin", "safetensors", "dir"])
@pytest.mark.parametrize("kind,prefix", [
    ("bert", ""), ("bert", "bert."), ("xlmr", ""), ("xlmr", "roberta.")])
def test_hf_text_import_equals_jax(tmp_path, monkeypatch, kind, prefix, fmt):
    """HF BERT / XLM-R weights into the text tower; the 128-row vocabulary
    against the model's 512 (mBERT tiny) is a shape issue, and a masked-LM
    head is unused.  JAX's load_initial_checkpoint reads only torch files:
    its load_hf_bert_into reads the .safetensors and the directory."""
    import safetensors.torch

    cfgs = _cfgs(text=kind)
    hf = _hf_text(kind)
    sd = {prefix + k: v.contiguous() for k, v in hf.state_dict().items()}
    sd["lm_head.dense.weight"] = torch.zeros(64, 64)
    folder = tmp_path / "hf"
    folder.mkdir()
    if fmt == "bin":
        path = folder / "pytorch_model.bin"
        torch.save(sd, path)
    else:
        path = folder / "model.safetensors"
        safetensors.torch.save_file(sd, str(path))
        if fmt == "dir":
            path = folder
    port, want, report, calls = _import_both(
        monkeypatch, cfgs, path,
        jax_load=None if fmt == "bin" else
        (lambda p: jweights.load_hf_bert_into(_init(cfgs)[0], p, cfgs[0])))
    _check(port, want, report, calls)
    assert report.flavor == "hf"
    shape = [i for i in report.issues if i.startswith("shape:")]
    if kind == "bert":  # mBERT tiny: 512 rows
        assert shape == ["shape: text_encoder.word_embeddings.weight "
                         "(128, 64) vs (512, 64)"]
    else:
        assert shape == []
        torch.testing.assert_close(
            port.text_encoder.word_embeddings.weight.detach(),
            hf.embeddings.word_embeddings.weight.detach(), rtol=0, atol=0)
    assert "lm_head.dense.weight" in report.unused


def test_xlmr_tower_after_import_equals_hf(tmp_path):
    """The imported XLM-R tower computes what HF's XLMRobertaModel does."""
    cfg = _port_cfg(text="xlmr")
    hf = _hf_text("xlmr").eval()
    path = tmp_path / "pytorch_model.bin"
    torch.save({f"roberta.{k}": v for k, v in hf.state_dict().items()}, path)
    port = TorchLECCR(cfg.model, device="cpu")
    load_initial_checkpoint(str(path), port)
    ids = torch.tensor([[0, 17, 33, 9, 2, 1, 1], [0, 5, 6, 7, 8, 9, 2]])
    mask = (ids != 1).long()
    with torch.no_grad():
        want = hf(ids, attention_mask=mask).last_hidden_state
        got = port.encode_text(ids, mask)
    torch.testing.assert_close(got[mask.bool()], want[mask.bool()], rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("where", ["file", "checkpoints_dir", "output_dir"])
def test_port_checkpoint_import(tmp_path, where):
    """The port's own CheckpointManager files load strictly, bit for bit."""
    cfg = _port_cfg()
    trained = TorchLECCR(cfg.model, device="cpu", seed=11)
    mgr = CheckpointManager(str(tmp_path / "out"))
    mgr.save(7, trained.state_dict(), {}, epoch=0)
    mgr.save(9, trained.state_dict(), {}, epoch=0)
    mgr.wait()
    path = {"file": mgr.dir / "step_00000009.pt",
            "checkpoints_dir": mgr.dir,
            "output_dir": tmp_path / "out"}[where]
    fresh = TorchLECCR(cfg.model, device="cpu", seed=12)
    report = load_initial_checkpoint(str(path), fresh)
    assert report.flavor == "port" and report.issues == []
    _assert_sd_equal(fresh.state_dict(), trained.state_dict())


def test_orbax_directory_and_unknown_files_raise(tmp_path):
    cfg = _port_cfg()
    model = TorchLECCR(cfg.model, device="cpu")
    orbax = tmp_path / "orbax_step"
    orbax.mkdir()
    (orbax / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(ValueError, match="orbax.*params_from_jax"):
        load_initial_checkpoint(str(orbax), model)
    other = tmp_path / "other.pt"
    torch.save({"some.weight": torch.ones(2)}, other)
    with pytest.raises(ValueError, match="unrecognized checkpoint flavor"):
        load_initial_checkpoint(str(other), model)
    with pytest.raises(FileNotFoundError):
        load_initial_checkpoint(str(tmp_path), model)


def test_graft_lists_missing_modules_once(tmp_path):
    cfg = _port_cfg()
    model = TorchLECCR(cfg.model, device="cpu")
    report = tweights.ImportReport("test")
    src = {"layers.0.query.weight": torch.ones(1),
           "layers.0.query.bias": torch.ones(1),
           "layers.7.attention.query.weight": torch.ones(64, 64),
           "layers.7.attention.key.weight": torch.ones(64, 64),
           "word_embeddings.weight": torch.ones(512, 64),
           "foo": torch.ones(1)}
    before = model.text_encoder.word_embeddings.weight.detach().clone()
    tweights._graft(model, "text_encoder.", src, report, "BERT")
    (_, grafted, issues), = report.sections
    assert grafted == ["text_encoder.word_embeddings.weight"]
    assert issues == ["unexpected: text_encoder.layers.0.query",
                      "unexpected: text_encoder.layers.7",
                      "unexpected: text_encoder.foo"]
    assert torch.equal(model.text_encoder.word_embeddings.weight,
                       torch.ones(512, 64))
    assert not torch.equal(before, torch.ones(512, 64))
    assert all(p.dtype == torch.float32 for p in model.parameters())
