"""RandAugment on a batch of images on their device (the port of
`leccr_tpu/data/randaugment.py`).

Every op is a plain function on a batch `x` of f32 images [B, H, W, 3] in
[0, 1], on x's device, at magnitude `mag` (0..10), with the JAX package's
semantics: Equalize, Solarize and Posterize are its integer arithmetic bit
for bit; the rest are its float arithmetic, and agree with it within f32
rounding.  An op's random argument is explicit: the geometric ops take
`arg` [B] = the sign (±1) of their magnitude, Cutout takes `arg` [B, 2] =
its two uniforms (the patch centre); the other ops ignore it.

    draws = sample_policy(b, n_ops, len(ops), gen)   # on the host
    x = apply_policy(x, draws, magnitude, ops)       # on x's device
    x = rand_augment_batch(x, gen, n_ops, magnitude) # the two together

The policy (reference randaugment.py:310-334): per image, `n_ops` ops drawn
uniformly with replacement from `ops`, each applied with probability 0.5
(skipped where its gate uniform exceeds 0.5) at magnitude M.  The draws are
a few scalars per image, made on the host from an explicit CPU
`torch.Generator`, so the device never waits for them and the same
generator state gives the same batch on the CPU and on the card.  They are
not `jax.random`'s bits.  Each op runs once a round, on the images that
drew it (index_select / index_copy_), not on every image as JAX's
vmap(switch) does.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

FILL = 128.0 / 255.0  # reference replace_value=(128,128,128)
_LUMA = (0.299, 0.587, 0.114)  # PIL RGB weights (JAX module's docstring)


def _enhance_factor(mag: float) -> float:
    return (mag / 10.0) * 1.8 + 0.1  # reference enhance_level_to_args


def _u8_levels(x: torch.Tensor) -> torch.Tensor:
    """round(x · 255) clipped to [0, 255], in f32 (half to even, as
    jnp.round)."""
    return torch.clamp(torch.round(x * 255.0), 0.0, 255.0)


def _sample_affine(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Apply per-image 2x3 inverse affines m [B, 2, 3] (output -> input
    coordinates) with bilinear sampling that clamps the neighbours to the
    nearest pixel (`map_coordinates(order=1, mode="nearest")`, summed in its
    order); output pixels whose source lies outside [0, w-1] x [0, h-1]
    take FILL."""
    b, h, w, c = x.shape
    ys = torch.arange(h, dtype=torch.float32, device=x.device)[None, :, None]
    xs = torch.arange(w, dtype=torch.float32, device=x.device)[None, None, :]
    m = m.to(device=x.device, dtype=torch.float32)[:, :, :, None, None]
    src_x = m[:, 0, 0] * xs + m[:, 0, 1] * ys + m[:, 0, 2]
    src_y = m[:, 1, 0] * xs + m[:, 1, 1] * ys + m[:, 1, 2]
    inside = ((src_x >= 0) & (src_x <= w - 1)
              & (src_y >= 0) & (src_y <= h - 1))[..., None]
    y0, x0 = torch.floor(src_y), torch.floor(src_x)
    wy1, wx1 = src_y - y0, src_x - x0
    wy0, wx0 = 1 - wy1, 1 - wx1
    iy0, ix0 = y0.to(torch.int64), x0.to(torch.int64)
    flat = x.reshape(b, h * w, c)

    def at(iy, ix):
        idx = (iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)).reshape(b, -1, 1)
        return torch.gather(flat, 1, idx.expand(b, h * w, c)).reshape(
            b, h, w, c)

    out = ((wy0 * wx0)[..., None] * at(iy0, ix0)
           + (wy0 * wx1)[..., None] * at(iy0, ix0 + 1)
           + (wy1 * wx0)[..., None] * at(iy0 + 1, ix0)
           + (wy1 * wx1)[..., None] * at(iy0 + 1, ix0 + 1))
    return torch.where(inside, out, torch.full_like(out, FILL))


def _identity_affines(b: int) -> torch.Tensor:
    m = torch.zeros(b, 2, 3)
    m[:, 0, 0] = m[:, 1, 1] = 1.0
    return m


def identity(x, mag=0, arg=None):
    return x


def brightness(x, mag, arg=None):
    # PIL ImageEnhance.Brightness: blend with black
    return torch.clamp(x * _enhance_factor(mag), 0.0, 1.0)


def _gray(x: torch.Tensor) -> torch.Tensor:
    return x @ torch.tensor(_LUMA, dtype=torch.float32, device=x.device)


def color(x, mag, arg=None):
    # PIL ImageEnhance.Color: blend with the grayscale image
    gray = _gray(x)[..., None]
    return torch.clamp(gray + _enhance_factor(mag) * (x - gray), 0.0, 1.0)


def contrast(x, mag, arg=None):
    # PIL ImageEnhance.Contrast: blend with each image's mean gray level
    mean = _gray(x).mean(dim=(1, 2))[:, None, None, None]
    return torch.clamp(mean + _enhance_factor(mag) * (x - mean), 0.0, 1.0)


def sharpness(x, mag, arg=None):
    """PIL-style sharpness: blend the interior with a 3x3 smoothing kernel
    (a zero-padded "same" convolution); the 1-pixel border stays
    untouched."""
    b, h, w, c = x.shape
    kernel = torch.tensor([[1., 1., 1.], [1., 5., 1.], [1., 1., 1.]],
                          device=x.device) / 13.0
    planes = x.permute(0, 3, 1, 2).reshape(b * c, 1, h, w)
    blurred = F.conv2d(planes, kernel[None, None], padding=1).reshape(
        b, c, h, w).permute(0, 2, 3, 1)
    out = torch.clamp(blurred + _enhance_factor(mag) * (x - blurred), 0.0,
                      1.0)
    interior = torch.zeros(h, w, 1, dtype=torch.bool, device=x.device)
    interior[1:h - 1, 1:w - 1] = True
    return torch.where(interior, out, x)


def autocontrast(x, mag=0, arg=None):
    lo = x.amin(dim=(1, 2), keepdim=True)
    hi = x.amax(dim=(1, 2), keepdim=True)
    spread = hi > lo
    scale = torch.where(spread, 1.0 / torch.clamp_min(hi - lo, 1e-6), 0.0)
    return torch.clamp(torch.where(spread, (x - lo) * scale, x), 0.0, 1.0)


def equalize(x, mag=0, arg=None):
    """PIL.ImageOps.equalize per image and channel, in integers: a
    256-bin histogram, step = (pixels − the last nonzero bin's count) //
    255, lut = clip(cumsum([step // 2, hist[:-1]]) // max(step, 1), 0,
    255); a channel whose step is 0 stays as it is."""
    b, h, w, c = x.shape
    planes = _u8_levels(x).to(torch.int64).permute(0, 3, 1, 2).reshape(
        b, c, h * w)
    offsets = torch.arange(b * c, device=x.device).reshape(b, c, 1) * 256
    hist = torch.bincount((planes + offsets).reshape(-1),
                          minlength=b * c * 256).reshape(b, c, 256)
    bins = torch.arange(256, device=x.device)
    last = torch.where(hist > 0, bins, 0).amax(dim=2, keepdim=True)
    step = (hist.sum(dim=2, keepdim=True)
            - torch.gather(hist, 2, last)) // 255
    n = torch.cat([step // 2, hist[:, :, :-1]], dim=2)
    lut = torch.clamp(torch.cumsum(n, dim=2) // torch.clamp_min(step, 1),
                      0, 255)
    out = (torch.gather(lut, 2, planes).to(torch.float32) / 255.0).reshape(
        b, c, h, w).permute(0, 2, 3, 1)
    keep = (step == 0).reshape(b, 1, 1, c)
    return torch.where(keep, x, out)


def solarize(x, mag, arg=None):
    # invert pixels at or above the threshold (reference :77-85)
    thresh = int((mag / 10.0) * 256)
    v = _u8_levels(x)
    return torch.where(v < thresh, v, 255.0 - v) / 255.0


def posterize(x, mag, arg=None):
    # keep the top int(M/10*4) bits (reference :179-184,251-256)
    bits = int((mag / 10.0) * 4)
    mask = (255 << (8 - bits)) & 255 if bits > 0 else 0
    v = _u8_levels(x).to(torch.int32)
    return (v & mask).to(torch.float32) / 255.0


def invert(x, mag=0, arg=None):
    return 1.0 - x


def _signed(arg: torch.Tensor, mag: float, scale: float) -> torch.Tensor:
    """sign · (M/10) · scale in f32, in the JAX op's order."""
    return arg.to(torch.float32) * (mag / 10.0) * scale


def shear_x(x, mag, arg):
    # forward cv2 matrix [[1, s, 0], [0, 1, 0]] -> inverse for sampling
    m = _identity_affines(x.shape[0])
    m[:, 0, 1] = -_signed(arg, mag, 0.3).cpu()
    return _sample_affine(x, m)


def shear_y(x, mag, arg):
    m = _identity_affines(x.shape[0])
    m[:, 1, 0] = -_signed(arg, mag, 0.3).cpu()
    return _sample_affine(x, m)


def translate_x(x, mag, arg):
    # offset = ±M/10 · 10 pixels; the inverse adds it
    m = _identity_affines(x.shape[0])
    m[:, 0, 2] = _signed(arg, mag, 10.0).cpu()
    return _sample_affine(x, m)


def translate_y(x, mag, arg):
    m = _identity_affines(x.shape[0])
    m[:, 1, 2] = _signed(arg, mag, 10.0).cpu()
    return _sample_affine(x, m)


def rotate(x, mag, arg):
    # cv2.getRotationMatrix2D(center, deg) is the forward map; the inverse
    # is the rotation by -deg about the same center (w/2, h/2)
    deg = _signed(arg, mag, 30.0).cpu()
    rad = -deg * torch.tensor(math.pi / 180.0, dtype=torch.float32)
    h, w = x.shape[1], x.shape[2]
    cos, sin = torch.cos(rad), torch.sin(rad)
    cx, cy = w / 2.0, h / 2.0
    m = torch.stack([
        torch.stack([cos, sin, cx - cos * cx - sin * cy], dim=1),
        torch.stack([-sin, cos, cy + sin * cx - cos * cy], dim=1)], dim=1)
    return _sample_affine(x, m)


def cutout(x, mag, arg):
    """A square gray patch of side 2·pad, pad = int(M/10 · 40) // 2, about
    (floor(r1 · h), floor(r2 · w)); arg [B, 2] = (r1, r2)."""
    pad = int((mag / 10.0) * 40) // 2
    h, w = x.shape[1], x.shape[2]
    r = arg.to(device=x.device, dtype=torch.float32)
    ch = torch.floor(r[:, 0] * h)[:, None, None, None]
    cw = torch.floor(r[:, 1] * w)[:, None, None, None]
    ys = torch.arange(h, dtype=torch.float32, device=x.device)[None, :, None,
                                                               None]
    xs = torch.arange(w, dtype=torch.float32, device=x.device)[None, None, :,
                                                               None]
    inside = ((ys >= ch - pad) & (ys < ch + pad)
              & (xs >= cw - pad) & (xs < cw + pad))
    return torch.where(inside, torch.full_like(x, FILL), x)


# the reference's arg_dict bank (randaugment.py:288-308) + Cutout and Invert
OP_BANK: Dict[str, Callable[..., torch.Tensor]] = {
    "Identity": identity,
    "AutoContrast": autocontrast,
    "Equalize": equalize,
    "Rotate": rotate,
    "Solarize": solarize,
    "Color": color,
    "Contrast": contrast,
    "Brightness": brightness,
    "Sharpness": sharpness,
    "ShearX": shear_x,
    "ShearY": shear_y,
    "TranslateX": translate_x,
    "TranslateY": translate_y,
    "Posterize": posterize,
    "Cutout": cutout,
    "Invert": invert,
}

# the live policy (reference dataset/__init__.py:47-48)
LIVE_POLICY = ("Identity", "AutoContrast", "Equalize", "Brightness",
               "Sharpness", "ShearX", "ShearY", "TranslateX", "TranslateY",
               "Rotate")


class PolicyDraws(NamedTuple):
    """The host draws of one batch, per image and round: `op` [B, n] the
    op's position in `ops`, `gate` [B, n] (applied where <= 0.5), `sign`
    [B, n] (±1, the geometric ops' argument) and `centre` [B, n, 2]
    (Cutout's uniforms)."""

    op: torch.Tensor
    gate: torch.Tensor
    sign: torch.Tensor
    centre: torch.Tensor


def sample_policy(b: int, n_ops: int, n_bank: int,
                  gen: torch.Generator) -> PolicyDraws:
    """The draws of a batch of `b` images from the CPU generator `gen`, in
    one fixed order."""
    op = torch.randint(0, n_bank, (b, n_ops), generator=gen)
    gate = torch.rand((b, n_ops), generator=gen)
    u = torch.rand((b, n_ops, 3), generator=gen)
    sign = torch.where(u[..., 0] > 0.5, -1.0, 1.0)
    return PolicyDraws(op, gate, sign, u[..., 1:])


def apply_policy(x: torch.Tensor, draws: PolicyDraws, magnitude: int = 7,
                 ops: Tuple[str, ...] = LIVE_POLICY) -> torch.Tensor:
    """The batch x [B, H, W, 3] (f32 in [0, 1]) after the drawn policy:
    round by round, each op once, on the images that drew it and whose gate
    fired.  Returns a new tensor; x is not written."""
    x = x.clone()
    for i in range(draws.op.shape[1]):
        fired = draws.gate[:, i] <= 0.5
        for j, name in enumerate(ops):
            if name == "Identity":
                continue
            rows = torch.nonzero(fired & (draws.op[:, i] == j))[:, 0]
            if rows.numel() == 0:
                continue
            arg = (draws.centre[rows, i] if name == "Cutout"
                   else draws.sign[rows, i])
            dev_rows = rows.to(x.device)
            x.index_copy_(0, dev_rows, OP_BANK[name](
                x.index_select(0, dev_rows), magnitude, arg))
    return x


def rand_augment_batch(images: torch.Tensor, gen: torch.Generator,
                       n_ops: int = 2, magnitude: int = 7,
                       ops: Tuple[str, ...] = LIVE_POLICY) -> torch.Tensor:
    """The policy over a batch [B, H, W, 3] of f32 images in [0, 1]: n_ops
    draws with replacement from `ops` per image, each applied with
    probability 0.5, at `magnitude`; the draws come from the CPU generator
    `gen`."""
    draws = sample_policy(images.shape[0], n_ops, len(ops), gen)
    return apply_policy(images, draws, magnitude, ops)
