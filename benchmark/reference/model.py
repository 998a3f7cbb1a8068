"""The parts of the plain reference that every block kind shares, in
float32 PyTorch. A configuration's reference module
(``benchmark/reference/<module>.py``) subclasses ``Backbone`` with its
block's feed-forward and hands the subclass to ``forward``.

It follows the model as the configuration states it, from the flat
parameters the benchmark made (``layout.param_shapes``) and from nothing
that the program under test made:

  * the backbone's and the focal streams' float parameters at their
    bfloat16 values (the policy's compute dtype); the heads' in float32;
  * each dense projection of a block (q, k, v, attn_out and the
    feed-forward's) and each focal iteration's fused q/k/v projection at
    ``bits`` (8 for the int8 policy): the weight quantised per output
    channel from its float32 value, the activations per row, symmetric,
    round half to even; the product of the dequantised values in float32;
  * every activation in float32 (TF32 off).

Layers, in order: ImageNet normalisation of uint8 images; the patch
embedding with the bicubic interpolation of the position embeddings (half
pixel, A = -0.75, border replicated; none where the grid is the pretrain
grid); the pre-LN blocks with LayerScale (the feed-forward the module's);
the token filter (CLS attention of the next block averaged over heads, the
guidance priority, the kept set and the fused context token, the frozen
dropped tokens put back); the final LayerNorm; the curiosity VAE with its
hierarchical terms; the ambient MLP; the iterative focal streams with their
fallbacks and re-focus; the guided blend and re-pool; the EXIF prior; the
fusion and the depth and confidence heads. Noise is zero (the
configuration's ``noise_mode``).

Its tables (guidance masks, focal positional encoding, centre bias, resize
matrices) are built here.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional, Tuple, Type

import torch
import torch.nn.functional as F

from benchmark.reference.layout import Dims

INSTRUCTIONS = ("center", "left", "right", "top", "bottom", "top-left", "top-right",
                "bottom-left", "bottom-right")
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@contextlib.contextmanager
def float32_matmuls():
    """TF32 off for the duration (restored after)."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


# ------------------------------------------------------------------ tables ----
def mask_table(g: int, device) -> torch.Tensor:
    """[9, g*g] guidance weights, rows in ``INSTRUCTIONS`` order: centre
    tiers 3.0 within g//4 and 1.5 within twice that; each direction 5.0
    within g//6 of its anchor and 2.0 within twice that; 1.0 elsewhere."""
    yy, xx = torch.meshgrid(torch.arange(g), torch.arange(g), indexing="ij")
    q, h, t = g // 4, g // 2, g * 3 // 4
    anchors = {"left": (h, q), "right": (h, t), "top": (q, h), "bottom": (t, h),
               "top-left": (q, q), "top-right": (q, t), "bottom-left": (t, q),
               "bottom-right": (t, t)}
    rows = []
    for name in INSTRUCTIONS:
        if name == "center":
            (fy, fx), r, inner, outer = (h, h), max(1, g // 4), 3.0, 1.5
        else:
            (fy, fx), r, inner, outer = anchors[name], max(1, g // 6), 5.0, 2.0
        d2 = (yy - fy) ** 2 + (xx - fx) ** 2  # integer: the radius tests are exact
        m = torch.ones(g, g)
        m[d2 <= (2 * r) ** 2] = outer
        m[d2 <= r * r] = inner
        rows.append(m.reshape(-1))
    return torch.stack(rows).to(device)


def focal_pos_encoding(n: int, d: int, device) -> torch.Tensor:
    """[n, d] 2-D sine/cosine encoding of a square grid: rows in the first
    half of the channels, columns in the second, even channels sine."""
    g = int(round(math.sqrt(n)))
    if g * g != n:
        raise ValueError(f"the reference's focal encoding takes square grids, got {n}")
    pe = torch.zeros(n, d, dtype=torch.float64)
    half = d // 2
    div = torch.exp(torch.arange(0, half, 2, dtype=torch.float64) * -(math.log(10000.0) / half))
    div = div.float().double()  # the frequencies as float32 values
    r = (torch.arange(n) // g).double()[:, None]
    c = (torch.arange(n) % g).double()[:, None]
    pe[:, 0:half:2] = torch.sin(r * div)
    pe[:, 1:half:2] = torch.cos(r * div)
    pe[:, half::2] = torch.sin(c * div)
    pe[:, half + 1::2] = torch.cos(c * div)
    return pe.float().to(device)


def center_bias(n: int, device, strength: float = 0.3) -> torch.Tensor:
    """[n] Gaussian centre bias of a square grid, sigma = grid / 6."""
    g = int(round(math.sqrt(n)))
    c = g // 2
    yy, xx = torch.meshgrid(torch.arange(g), torch.arange(g), indexing="ij")
    d2 = ((xx - c) ** 2 + (yy - c) ** 2).double()
    return (torch.exp(-d2 / (2 * (g / 6.0) ** 2)) * strength).reshape(-1).float().to(device)


def bicubic_matrix(src: int, dst: int, device) -> torch.Tensor:
    """[dst, src]: bicubic resampling along one axis, half-pixel source
    coordinates, border replicated, cubic convolution with A = -0.75."""
    a = -0.75

    def cubic(x):
        x = abs(x)
        if x <= 1.0:
            return (a + 2) * x ** 3 - (a + 3) * x ** 2 + 1
        if x < 2.0:
            return a * x ** 3 - 5 * a * x ** 2 + 8 * a * x - 4 * a
        return 0.0

    w = torch.zeros(dst, src, dtype=torch.float64)
    for i in range(dst):
        pos = (i + 0.5) * src / dst - 0.5
        base = math.floor(pos)
        for off in (-1, 0, 1, 2):
            j = min(max(base + off, 0), src - 1)
            w[i, j] += cubic(pos - (base + off))
    return w.float().to(device)


# ------------------------------------------------------------- arithmetic ----
def bf16(t: torch.Tensor) -> torch.Tensor:
    """A float32 tensor at the bfloat16 value of ``t``."""
    return t.to(torch.bfloat16).float()


def quantize(x: torch.Tensor, bits: int, dim: int) -> torch.Tensor:
    """Symmetric fake quantisation along ``dim`` (one scale per slice):
    s = max(max|x| / qmax, 1e-12), q = clip(round(x / s), -qmax, qmax),
    returns q * s. qmax = 2^(bits-1) - 1."""
    qmax = float(2 ** (bits - 1) - 1)
    s = (x.abs().amax(dim=dim, keepdim=True) / x.new_full((1,), qmax)).clamp(min=1e-12)
    return torch.clamp(torch.round(x / s), -qmax, qmax) * s


def qlinear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, bits: int) -> torch.Tensor:
    """x [..., in] through the quantised weight w [in, out] (one scale per
    output column) with x quantised per row, plus b."""
    return quantize(x, bits, -1) @ quantize(w, bits, 0) + b


def linear(x, p, name, round_params=False):
    w, b = p[f"{name}/w"], p[f"{name}/b"]
    if round_params:
        w, b = bf16(w), bf16(b)
    return x @ w + b


def mlp(x, p, name, n, final=None, round_params=False):
    for i in range(n):
        x = linear(x, p, f"{name}/fc{i}", round_params)
        if i < n - 1:
            x = F.relu(x)
    return final(x) if final is not None else x


def gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def layer_norm(x, scale, bias, eps):
    return F.layer_norm(x, (x.shape[-1],), bf16(scale), bf16(bias), eps)


def unbiased_var(x):
    """Over every element of the batch, as the focal fallbacks test it."""
    return ((x - x.mean()) ** 2).sum() / max(x.numel() - 1, 1)


# --------------------------------------------------------------- backbone ----
class Backbone:
    """The embedding, the pre-LN blocks with LayerScale, the token filter
    and the final LayerNorm; a subclass supplies ``feed_forward``."""

    def __init__(self, p: Dict[str, torch.Tensor], d: Dims, bits: int):
        self.p, self.d, self.bits = p, d, bits

    def layer(self, i: int, name: str) -> torch.Tensor:
        return self.p[f"backbone/layers/{name}"][i]

    def embed(self, images: torch.Tensor) -> torch.Tensor:
        d, p = self.d, self.p
        B, H, W, C = images.shape
        ps, gh, gw = d.patch, H // d.patch, W // d.patch
        x = images.reshape(B, gh, ps, gw, ps, C).permute(0, 1, 3, 2, 4, 5)
        x = linear(x.reshape(B, gh * gw, ps * ps * C), p, "backbone/patch_embed", True)
        pos = p["backbone/pos_embed"]
        src = int(round(math.sqrt(pos.shape[1] - 1)))
        if not (gh == gw == src):
            grid = pos[:, 1:].reshape(src, src, -1)
            wh = bicubic_matrix(src, gh, images.device)
            ww = bicubic_matrix(src, gw, images.device)
            grid = torch.einsum("oh,hwd->owd", wh, grid)
            grid = torch.einsum("pw,owd->opd", ww, grid)
            pos = torch.cat([pos[:, :1], grid.reshape(1, gh * gw, -1)], dim=1)
        cls = bf16(p["backbone/cls_token"]).expand(B, 1, -1)
        return torch.cat([cls, x], dim=1) + pos

    def attention(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """x plus block i's LayerScaled attention."""
        d, L, q = self.d, self.layer, self.bits
        B, N, D = x.shape
        hd = D // d.heads
        h = layer_norm(x, L(i, "norm1/scale"), L(i, "norm1/bias"), d.eps)
        hq = quantize(h, q, -1)
        qkv = [hq @ quantize(L(i, f"{n}/w"), q, 0) + bf16(L(i, f"{n}/b")) for n in "qkv"]
        qh, kh, vh = (t.reshape(B, N, d.heads, hd).transpose(1, 2) for t in qkv)
        att = torch.softmax(qh @ kh.transpose(-1, -2) * hd ** -0.5, dim=-1)
        ctx = (att @ vh).transpose(1, 2).reshape(B, N, D)
        out = qlinear(ctx, L(i, "attn_out/w"), bf16(L(i, "attn_out/b")), q)
        return x + bf16(L(i, "ls1")) * out

    def feed_forward(self, i: int, h: torch.Tensor) -> torch.Tensor:
        """Block i's feed-forward of its normalised input ``h``: the
        reference module's."""
        raise NotImplementedError

    def block(self, i: int, x: torch.Tensor) -> torch.Tensor:
        x = self.attention(i, x)
        h = layer_norm(x, self.layer(i, "norm2/scale"), self.layer(i, "norm2/bias"), self.d.eps)
        return x + bf16(self.layer(i, "ls2")) * self.feed_forward(i, h)

    def cls_importance(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """[B, P]: the CLS row of block i's attention, averaged over heads,
        at the patch columns."""
        d, L, q = self.d, self.layer, self.bits
        B, N, D = x.shape
        hd = D // d.heads
        h = layer_norm(x, L(i, "norm1/scale"), L(i, "norm1/bias"), d.eps)
        qc = h[:, 0] @ quantize(L(i, "q/w"), q, 0) + bf16(L(i, "q/b"))
        k = h @ quantize(L(i, "k/w"), q, 0) + bf16(L(i, "k/b"))
        s = torch.einsum("bhd,bnhd->bhn", qc.reshape(B, d.heads, hd),
                         k.reshape(B, N, d.heads, hd)) * hd ** -0.5
        return torch.softmax(s, dim=-1).mean(dim=1)[:, 1:]

    def forward(self, images, keep_weights=None, token_filter=None) -> torch.Tensor:
        """[B, 1+P, D] after the final LayerNorm. ``token_filter``: (layer,
        keep share) of the fused single-stage filter, or None."""
        d, p = self.d, self.p
        x = self.embed(images)
        if token_filter is None:
            for i in range(d.layers):
                x = self.block(i, x)
        else:
            layer, keep = token_filter
            for i in range(layer):
                x = self.block(i, x)
            imp = self.cls_importance(layer, x)
            B, P = imp.shape
            k = max(1, int(round(keep * P)))
            prio = imp if keep_weights is None else imp + 10.0 * (keep_weights - 1.0)
            # the k largest, the lower index first among equals; then ascending
            order = torch.sort(prio, dim=1, descending=True, stable=True).indices
            idx = torch.sort(order[:, :k], dim=1).values
            dropped = torch.ones(B, P, device=x.device).scatter_(1, idx, 0.0)
            w = imp * dropped
            patches = x[:, 1:]
            fused = (patches * w[..., None]).sum(1, keepdim=True) / (
                w.sum(1, keepdim=True)[..., None] + 1e-9)
            kept = patches.gather(1, idx[..., None].expand(-1, -1, x.shape[-1]))
            y = torch.cat([x[:, :1], kept, fused], dim=1)
            for i in range(layer, d.layers):
                y = self.block(i, y)
            patches = patches.scatter(1, idx[..., None].expand(-1, -1, x.shape[-1]),
                                      y[:, 1:1 + k])
            x = torch.cat([y[:, :1], patches], dim=1)
        return layer_norm(x, p["backbone/final_norm/scale"], p["backbone/final_norm/bias"],
                          d.eps)


# ------------------------------------------------------------------ heads ----
def curiosity(p, f):
    """The curiosity reward [B] of the CLS features, exif absent, noise zero."""
    c = "curiosity_module"
    mu = mlp(f, p, f"{c}/encoder_mean", 2)
    logvar = mlp(f, p, f"{c}/encoder_logvar", 2)
    recon = mlp(mu, p, f"{c}/decoder", 2)  # z = mu + 0 * std
    err = torch.sqrt(((recon - f[:, :recon.shape[1]]) ** 2).sum(1) + 1e-8)
    err = (err / (1.0 + err)).clamp(min=0.0)
    kl = (-0.5 * (1.0 + logvar - mu ** 2 - torch.exp(logvar)).sum(1)).clamp(min=0.0)
    unc = mlp(f, p, f"{c}/uncertainty_head", 2, F.softplus)[:, 0].clamp(0.0, 10.0)
    basic = err + 0.1 * kl + 0.1 * unc
    geo = torch.full_like(basic, 0.5)
    local = mlp(f, p, f"{c}/local_curiosity", 2, torch.sigmoid)[:, 0].clamp(0.0, 1.0)
    w = torch.softmax(p[f"{c}/curiosity_weights"], dim=0)
    return (w[0] * geo + w[1] * local + w[2] * basic).clamp(0.0, 100.0)


def focal_stream(p, d: Dims, patches, bits):
    """(features [B, 64], last attention [B, P]) of the iterative focal
    streams over the patch tokens."""
    B, N, D = patches.shape
    pe, cb = focal_pos_encoding(N, D, patches.device), center_bias(N, patches.device)
    cur, feats, final = patches, [], None
    for i in range(d.num_iterations):
        s = f"focal_stream/streams/{i}"
        x = cur + pe
        xq = quantize(x, bits, -1)
        q, k, v = (xq @ quantize(p[f"{s}/{n}_proj/w"], bits, 0) + bf16(p[f"{s}/{n}_proj/b"])
                   for n in ("query", "key", "value"))
        att = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(D // 8), dim=-1)
        attended = att @ v
        pa = att.mean(1) + cb
        pa = torch.where(unbiased_var(pa) < 1e-6, torch.diagonal(att, dim1=1, dim2=2) + cb, pa)
        pa = torch.where(unbiased_var(pa) < 1e-6, att.amax(-1) + cb, pa)
        pa = torch.where(unbiased_var(pa) < 1e-6, torch.linalg.vector_norm(x, dim=-1), pa)
        pa = pa / (pa.sum(-1, keepdim=True) + 1e-8)
        final = pa.clamp(min=1e-8)
        final = final / (final.sum(-1, keepdim=True) + 1e-8)
        feats.append(mlp((attended * final[..., None]).sum(1), p, f"{s}/projection", 2,
                         round_params=True))
        if i < d.num_iterations - 1:
            cur = cur * (1.0 + d.focus_strength * final[..., None])
    fused = mlp(torch.cat(feats, 1), p, "focal_stream/fusion", 2, round_params=True)
    return fused, final


def exif_prior(p, exif):
    cam = p["exif_prior/camera_embedding/table"][exif["camera_idx"].long()]
    cont = torch.stack([exif["focal_length"].float(), exif["aperture"].float(),
                        torch.log(exif["iso"].float() + 1.0)], dim=1)
    ef = mlp(cont, p, "exif_prior/exif_encoder", 2)
    return mlp(torch.cat([cam, ef], 1), p, "exif_prior/fusion", 2)


def normalize_u8(images: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(IMAGENET_MEAN, device=images.device)
    std = torch.tensor(IMAGENET_STD, device=images.device)
    return (images.float() / 255.0 - mean) / std


@torch.no_grad()
def forward(backbone: Type[Backbone], p: Dict[str, torch.Tensor], d: Dims, images: torch.Tensor,
            exif: Dict[str, torch.Tensor], guidance: Optional[torch.Tensor], *,
            token_filter: Optional[Tuple[int, float]] = None, bits: int = 8,
            rows: int = 8) -> Dict[str, torch.Tensor]:
    """The forward of a batch through the blocks of ``backbone``, a
    ``Backbone`` subclass: images [B, H, W, 3] (uint8, or float32
    normalised), exif {camera_idx, focal_length, aperture, iso} [B],
    guidance [B] instruction indices or None. The backbone runs ``rows``
    images at a time; the streams see the whole batch, whose variance the
    focal fallbacks test. Returns depth, confidence, curiosity [B], the
    attention map and the focal attention [B, P]."""
    with float32_matmuls():
        dev = images.device
        x = normalize_u8(images) if images.dtype == torch.uint8 else images.float()
        B = x.shape[0]
        table = mask_table(d.grid, dev)
        kw = None if guidance is None else table[guidance.long()]
        bb = backbone(p, d, bits)
        hs = torch.cat([bb.forward(x[a:a + rows], None if kw is None else kw[a:a + rows],
                                   token_filter) for a in range(0, B, rows)])
        cls, patches = hs[:, 0], hs[:, 1:]
        cur = curiosity(p, cls)
        amb = mlp(cls, p, "ambient_stream/mlp", 3)
        feats, focal = focal_stream(p, d, patches, bits)
        attention = focal
        if kw is not None:
            attention = torch.softmax((0.7 * kw + 0.3 * focal) / 0.05, dim=-1)
            feats = linear((patches * attention[..., None]).sum(1), p, "guided_projection")
        fused = F.relu(mlp(torch.cat([amb, feats, exif_prior(p, exif)], 1), p, "fusion", 1))
        depth = F.softplus(mlp(fused, p, "decision_head", 1))[:, 0]
        conf = torch.sigmoid(mlp(fused, p, "confidence_head", 2))[:, 0]
        return {"depth": depth, "confidence": conf, "curiosity": cur,
                "attention": attention, "focal_attention": focal}
