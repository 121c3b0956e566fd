"""DeepSeek-V2's decoder block as LECCR's text tower and caption encoder,
in plain float32 PyTorch: the reference of a configuration whose
`model.text.kind` is `deepseek_v2`, beside `benchmark.reference.model`
(whose vision tower, caption interaction, heads and losses it reuses).

Written from the DeepSeek-V2 paper (arXiv 2405.04434) and
`modeling_deepseek.py` beside the published checkpoints
(https://huggingface.co/deepseek-ai/DeepSeek-V2-Lite).  Each layer, in
pre-norm residual form: RMSNorm (eps from the file); multi-head latent
attention without query compression (q split into a no-RoPE and a RoPE
part, a 512 + 64 down-projection of the keys and values whose latent is
RMS-normed and up-projected to each head's k_nope and v, the one k_pe
shared by all heads, YaRN RoPE in the de-interleaved layout, a causal
softmax over the valid keys at (q_head_dim)^-½ · mscale²); a dense SwiGLU
first layer, then MoE layers: a softmax router over all experts, its
greedy top-k unnormalised, the chosen experts among those this card holds
(the others' part is left out, as the deployment's other cards would add
it) plus the shared experts.  The text feature is the last valid token's
(texts are right-padded).

Departures from `modeling_deepseek.py`, all stated in the configuration
file: the sequence-wise balance loss counts valid tokens only (the
published code trains on packed text and counts every position), its
weight α is assumed, and there is no LM head.

A training forward may be routed by the choices the program made
(`routes`: {call: [per MoE layer [B, L, k], -1 at padding]}): its own f32
scores then weigh the program's experts, and `mismatched` counts, per
(call, layer), the valid tokens whose own top-k set differs from the
program's.  Without that, a near tie that bf16 rounding flips would move
every number the comparison reads by a discrete step.  The MoE layers of
a forward that takes a gradient are recomputed in the backward
(`torch.utils.checkpoint`), which changes no number: the reference holds
one layer's activations at a time, as memory asks at the cell's size.

It imports nothing of the program and of the JAX package, and turns TF32
off (through `Model`).
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.reference.model import (
    Arch,
    Model,
    Precision,
    Streams,
    l2n,
    step_stream_seed,
    train_images,
)
from benchmark.reference.train import LOSS_KEYS, losses, norms, settings

# parameters outside AdamW's weight decay: biases, LayerNorm and RMSNorm
# scales
_NO_DECAY = re.compile(
    r"(\.bias$|(^|\.)(ln_1|ln_2|ln_pre|ln_post|ln_final|embeddings_ln|"
    r"out_ln|output_ln|norm|input_layernorm|post_attention_layernorm|"
    r"kv_a_layernorm)\.weight$)")


@dataclasses.dataclass(frozen=True)
class Tower:
    """The text tower's shapes (the configuration's `model.text`)."""

    hidden: int
    layers: int
    heads: int
    inter: int
    kv_rank: int
    nope: int
    rope: int
    v_dim: int
    moe_inter: int
    experts: int
    top_k: int
    shared: int
    dense_first: int
    eps: float
    theta: float
    yarn: tuple
    held: int
    offset: int
    alpha: float

    @staticmethod
    def of(text: dict) -> "Tower":
        """The tower of a configuration's `model.text` block, its
        DeepSeek-V2 widths under `deepseek`."""
        d = text["deepseek"]
        return Tower(
            hidden=text["hidden_size"], layers=text["num_layers"],
            heads=text["num_heads"], inter=text["intermediate_size"],
            kv_rank=d["kv_lora_rank"], nope=d["qk_nope_head_dim"],
            rope=d["qk_rope_head_dim"], v_dim=d["v_head_dim"],
            moe_inter=d["moe_intermediate_size"],
            experts=d["n_routed_experts"],
            top_k=d["num_experts_per_tok"],
            shared=d["n_shared_experts"],
            dense_first=d["first_k_dense_replace"],
            eps=float(d["rms_norm_eps"]), theta=float(d["rope_theta"]),
            yarn=tuple(sorted(d.get("rope_scaling", {}).items())),
            held=d.get("experts_held") or d["n_routed_experts"],
            offset=d.get("expert_offset", 0),
            alpha=float(d["aux_loss_alpha"]))

    @property
    def moe_layers(self) -> int:
        return self.layers - self.dense_first


def _mscale(scale: float, m: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0


def rope_tables(t: Tower, length: int, device):
    """cos, sin [length, rope] of DeepSeek-V2's YaRN RoPE (plain RoPE
    without `rope_scaling`)."""
    dim = t.rope
    exps = torch.arange(0, dim, 2, dtype=torch.float32) / dim
    inv = 1.0 / t.theta ** exps
    scale = 1.0
    y = dict(t.yarn)
    if y:
        orig, factor = y["original_max_position_embeddings"], y["factor"]

        def corr(rot):
            return (dim * math.log(orig / (rot * 2 * math.pi))
                    / (2 * math.log(t.theta)))

        lo = max(math.floor(corr(y["beta_fast"])), 0)
        hi = min(math.ceil(corr(y["beta_slow"])), dim - 1)
        hi = hi + 0.001 if lo == hi else hi
        ramp = ((torch.arange(dim // 2, dtype=torch.float32) - lo)
                / (hi - lo)).clamp(0, 1)
        inv = (inv / factor) * ramp + inv * (1 - ramp)
        scale = (_mscale(factor, y.get("mscale", 1.0))
                 / _mscale(factor, y.get("mscale_all_dim", 0.0)))
    freqs = torch.outer(torch.arange(length, dtype=torch.float32), inv)
    emb = torch.cat([freqs, freqs], -1)
    return (emb.cos() * scale).to(device), (emb.sin() * scale).to(device)


def softmax_scale(t: Tower) -> float:
    y = dict(t.yarn)
    m = _mscale(y["factor"], y["mscale_all_dim"]) if y.get(
        "mscale_all_dim") else 1.0
    return (t.nope + t.rope) ** -0.5 * m * m


def rope(x, cos, sin):
    """x [..., L, d]: the pairs (2i, 2i+1) moved to (i, i + d/2), then
    x·cos + rotate_half(x)·sin."""
    *lead, d = x.shape
    x = x.reshape(*lead, d // 2, 2).transpose(-1, -2).reshape(*lead, d)
    a, b = x.chunk(2, -1)
    return x * cos + torch.cat([-b, a], -1) * sin


def balance(scores, chosen, valid):
    """Σ_i f_i P_i per sequence over its valid tokens, the mean over the
    sequences: f_i = E / (k n) · (times i was chosen), P_i the mean score."""
    b, l, e = scores.shape
    k = chosen.shape[-1]
    v = valid.float()
    n = v.sum(1).clamp_min(1.0)
    f = torch.stack([((chosen == i) & valid[..., None]).float().sum((1, 2))
                     for i in range(e)], 1) * (e / k) / n[:, None]
    p = (scores * v[..., None]).sum(1) / n[:, None]
    return (f * p).sum(1).mean()


class MoEModel(Model):
    """`Model` with the deepseek_v2 text tower; see the module's
    docstring."""

    def __init__(self, P: Dict[str, torch.Tensor], arch: Arch, tower: Tower,
                 prec: Optional[Precision] = None,
                 routes: Optional[Dict[str, List[torch.Tensor]]] = None):
        super().__init__(P, arch, prec)
        self.t, self.routes = tower, routes
        self.mismatched: Dict[tuple, tuple] = {}

    def rms(self, x, name):
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True)
                               + self.t.eps) * self.P[name + ".weight"]

    def swiglu(self, x, gate, up, down):
        q = self.q
        return q.linear(F.silu(q.linear(x, gate)) * q.linear(x, up), down)

    def text(self, ids, mask, streams, call: str = "text",
             want: bool = False):
        """-> (hidden [B, L, H] after the final norm, the balance loss
        summed over the MoE layers and weighted where `want`, else
        None)."""
        t, pre = self.t, "text_encoder"
        valid = mask.bool()
        h = self.P[f"{pre}.embed_tokens.weight"][ids]
        cos, sin = rope_tables(t, ids.shape[1], ids.device)
        total = None
        for i in range(t.layers):
            args = (h, valid, cos, sin, i, call, want)
            if torch.is_grad_enabled():
                h, aux = checkpoint(self._layer, *args, use_reentrant=False)
            else:
                h, aux = self._layer(*args)
            if aux is not None:
                total = aux if total is None else total + aux
        h = self.rms(h, f"{pre}.norm")
        return h, None if total is None else total * t.alpha

    def _layer(self, h, valid, cos, sin, i, call, want):
        name = f"text_encoder.layers.{i}"
        h = h + self._mla(self.rms(h, f"{name}.input_layernorm"), valid, cos,
                          sin, f"{name}.self_attn")
        x = self.rms(h, f"{name}.post_attention_layernorm")
        if i < self.t.dense_first:
            m = f"{name}.mlp"
            return h + self.swiglu(
                x, *(self.P[f"{m}.{p}_proj.weight"]
                     for p in ("gate", "up", "down"))), None
        y, aux = self._moe(x, valid, f"{name}.mlp", call,
                           i - self.t.dense_first, want)
        return h + y, aux

    def _mla(self, x, valid, cos, sin, name):
        t = self.t
        b, l, _ = x.shape
        q = self.lin(x, f"{name}.q_proj", bias=False).view(
            b, l, t.heads, t.nope + t.rope).transpose(1, 2)
        q_nope, q_pe = q.split([t.nope, t.rope], -1)
        c, k_pe = self.lin(x, f"{name}.kv_a_proj_with_mqa", bias=False
                           ).split([t.kv_rank, t.rope], -1)
        kv = self.lin(self.rms(c, f"{name}.kv_a_layernorm"),
                      f"{name}.kv_b_proj", bias=False).view(
            b, l, t.heads, t.nope + t.v_dim).transpose(1, 2)
        k_nope, v = kv.split([t.nope, t.v_dim], -1)
        q = torch.cat([q_nope, rope(q_pe, cos, sin)], -1)
        k_pe = rope(k_pe.unsqueeze(1), cos, sin).expand(b, t.heads, l, t.rope)
        k = torch.cat([k_nope, k_pe], -1)
        s = self.q.matmul(q, k.transpose(-1, -2)) * softmax_scale(t)
        future = torch.ones(l, l, dtype=torch.bool, device=x.device).triu(1)
        s = torch.where(future | ~valid[:, None, None, :], -torch.inf, s)
        out = self.q.matmul(torch.softmax(s, -1), v)
        return self.lin(out.transpose(1, 2).reshape(b, l, -1),
                        f"{name}.o_proj", bias=False)

    def _moe(self, x, valid, name, call, j, want):
        t = self.t
        b, l, d = x.shape
        flat = x.reshape(-1, d)
        v = valid.reshape(-1)
        scores = torch.softmax(
            self.q.linear(flat, self.P[f"{name}.gate.weight"]), -1)
        own = torch.topk(scores, t.top_k, -1).indices
        chosen = own
        if self.routes is not None:
            given = self.routes[call][j]
            if given.shape == (b, l, t.top_k):
                chosen = torch.where(v[:, None], given.reshape(-1, t.top_k),
                                     own)
                differ = (own.sort(-1).values
                          != chosen.sort(-1).values).any(-1) & v
            else:  # the program routed other tokens: none of them agree
                differ = v
            self.mismatched[(call, j)] = (int(differ.sum()), int(v.sum()))
        w = scores.gather(1, chosen)
        y = torch.zeros_like(flat)
        st = f"{name}.experts"
        for e in range(t.held):
            hit = (chosen == t.offset + e) & v[:, None]
            rows = hit.any(1).nonzero().squeeze(1)
            out = self.swiglu(flat[rows], self.P[f"{st}.gate_proj"][e],
                              self.P[f"{st}.up_proj"][e],
                              self.P[f"{st}.down_proj"][e])
            y = y.index_add(0, rows, (w * hit).sum(1)[rows, None] * out)
        sh = f"{name}.shared_experts"
        y = y + self.swiglu(flat, *(self.P[f"{sh}.{p}_proj.weight"]
                                    for p in ("gate", "up", "down")))
        aux = (balance(scores.view(b, l, -1), chosen.view(b, l, -1), valid)
               if want else None)
        return y.view(b, l, d), aux

    def pool(self, hidden, mask):
        last = mask.long().sum(1) - 1
        return hidden[torch.arange(hidden.shape[0], device=hidden.device),
                      last]

    def train_forward(self, batch, streams: Streams):
        """`Model.train_forward` with this tower: the caption call, the
        text call pooled at the last valid token, and "balance"."""
        images = train_images(batch["vision"], batch.get("flip"))
        vis = self.vision(images, grad=True)
        with torch.no_grad():
            cap_hidden, _ = self.text(batch["caption_ids"],
                                      batch["caption_mask"], streams,
                                      "caption")
        fused_vis, fused_slots, ori_slots = self.interact(
            vis, cap_hidden, ~batch["caption_mask"].bool(), streams)
        image_feat = l2n(self.lin(fused_vis[:, 0], "vision_proj"))
        b = batch["text_ids_s"].shape[0]
        mask = torch.cat([batch["text_mask_s"], batch["text_mask_t"]])
        text, bal = self.text(torch.cat([batch["text_ids_s"],
                                         batch["text_ids_t"]]), mask,
                              streams, "text", want=True)
        text_feat = l2n(self.lin(self.pool(text, mask), "text_proj"))
        cap_norm = l2n(self.lin(ori_slots, "cproj"), dim=self.a.cv_dim)
        vis_norm = l2n(self.lin(vis, "vproj"), dim=self.a.cv_dim)
        return {"image_feat": image_feat, "text_feat_s": text_feat[:b],
                "text_feat_t": text_feat[b:],
                "slots": self.lin(fused_slots, "caption_proj1"),
                "ori_slots": ori_slots,
                "cv_caption_mean": cap_norm.mean(dim=1),
                "cv_vision_mean": vis_norm.mean(dim=1),
                "temp": self.P["temp"], "balance": bal}

    @torch.no_grad()
    def embed_texts(self, ids, mask):
        hidden, _ = self.text(ids, mask, None)
        return l2n(self.lin(self.pool(hidden, mask), "text_proj"))

    def routing_mismatches(self) -> tuple:
        """(valid tokens whose own top-k differs, valid tokens) over the
        routed calls."""
        got = list(self.mismatched.values())
        return sum(a for a, _ in got), sum(n for _, n in got)


def moe_losses(emb, idx, arch: Arch):
    """The suite's 10 losses, "total" with the balance loss."""
    out = losses(emb, idx, arch)
    out["total"] = out["total"] + emb["balance"]
    return out


def leaf_decay(name: str, config: dict) -> float:
    """AdamW's weight decay of the leaf `name`: none for biases, LayerNorm
    and RMSNorm scales."""
    wd = float(config.get("train", {}).get("optimizer", {})
               .get("weight_decay", 0.01))
    return 0.0 if _NO_DECAY.search(name) else wd


def reference_steps(P0: Dict[str, torch.Tensor], config: dict,
                    batches: Sequence[Dict[str, torch.Tensor]],
                    step_nos: Sequence[int], total_steps: int,
                    prec: Optional[Precision] = None,
                    routes: Optional[Sequence[dict]] = None) -> dict:
    """`benchmark.reference.train.reference_steps` for this tower: AdamW
    steps from P0 (left as they are) on `batches`, step k routed by
    routes[k] where given.  Returns its {"losses", "grads", "grad_norms",
    "change"} and "mismatched": (differing valid tokens, valid tokens)."""
    arch, tower = Arch.of(config["model"]), Tower.of(config["model"]["text"])
    s = settings(config, total_steps)
    lr_at, (b1, b2), eps, seed = s["lr_at"], s["betas"], s["eps"], s["seed"]
    P = {n: p.detach().clone().requires_grad_(True) for n, p in P0.items()}
    m = {n: torch.zeros_like(p) for n, p in P.items()}
    v = {n: torch.zeros_like(p) for n, p in P.items()}
    out: dict = {"losses": [], "mismatched": (0, 0), "by_layer": {}}
    for k, (batch, step_no) in enumerate(zip(batches, step_nos)):
        for p in P.values():
            p.grad = None
        model = MoEModel(P, arch, tower, prec,
                         None if routes is None else routes[k])
        emb = model.train_forward(batch, Streams(
            step_stream_seed(seed, step_no), batch["vision"].device))
        loss = moe_losses(emb, batch["idx"], arch)
        loss["total"].backward()
        out["losses"].append(torch.stack([loss[key].detach()
                                          for key in LOSS_KEYS]).cpu())
        out["mismatched"] = tuple(
            a + b for a, b in zip(out["mismatched"],
                                  model.routing_mismatches()))
        for key, (a, n) in model.mismatched.items():
            had = out["by_layer"].get(key, (0, 0))
            out["by_layer"][key] = (had[0] + a, had[1] + n)
        del emb, loss
        lr = lr_at(k)
        with torch.no_grad():
            if k == 0:
                out["grads"] = {n: p.grad.clone() if p.grad is not None
                                else torch.zeros_like(p)
                                for n, p in P.items()}
                out["grad_norms"] = norms(out["grads"])
            for n, p in P.items():
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                wd = leaf_decay(n, config)
                if wd:
                    p.mul_(1 - lr * wd)
                m[n].mul_(b1).add_(g, alpha=1 - b1)
                v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v[n].sqrt() / (1 - b2 ** (k + 1)) ** 0.5).add_(eps)
                p.addcdiv_(m[n], denom, value=-lr / (1 - b1 ** (k + 1)))
    with torch.no_grad():
        out["change"] = {n: P[n].detach() - P0[n] for n in P}
    return out


def reference_loss(P: Dict[str, torch.Tensor], config: dict,
                   batch: Dict[str, torch.Tensor], step_no: int,
                   prec: Optional[Precision] = None,
                   routes: Optional[dict] = None) -> tuple:
    """(the 10 losses [10] (host) of one training step's forward from the
    weights P, routed by `routes` where given; (differing valid tokens,
    valid tokens))."""
    arch, tower = Arch.of(config["model"]), Tower.of(config["model"]["text"])
    seed = int(config.get("train", {}).get("seed", 42))
    model = MoEModel(P, arch, tower, prec, routes)
    with torch.no_grad():
        emb = model.train_forward(batch, Streams(
            step_stream_seed(seed, step_no), batch["vision"].device))
        loss = moe_losses(emb, batch["idx"], arch)
        return (torch.stack([loss[key] for key in LOSS_KEYS]).cpu(),
                model.routing_mismatches())
