"""Plain PyTorch reference of the Point-SAM models the benchmark runs: what
every model kind shares (FPS, the 3-NN interpolation, the ViT, the
two-way decoder), written from the published architecture as plain tensor
functions over a parameter dict. What a kind has of its own (its groups,
its patch embedding, its mask prompt's encoder) is in
``reference/<kind>.py``, the module passed as ``kind`` here: ``knn.py``
(PointNet patches of each FPS centre's K nearest points) and
``voronoi.py`` (each point assigned to its nearest centre, a per-point MLP
max-pooled onto the centres). The dict holds fp32 tensors under the published
state-dict names (``pc_encoder.transformer.blocks.0.attn.proj.weight``);
the benchmark makes it from the seed and hands the same values to both
sides. Nothing here imports the program under test.

Everything runs in fp32 with TF32 off unless a ``Prec`` says otherwise;
``Prec`` is how the control of the comparison computes the same function
one precision lower. The geometry follows the program's published
definition: squared distances as fp32 fused multiply-adds (the
``fma(dz, dz, fma(dx, dx, dy * dy))`` of the farthest-point loop and the
3-NN weights; ``fma(z, z', fma(y, y', x x'))`` dot products of the kNN
expansion), ties to the smaller index.

Shapes: ``xyz`` [B, N, 3], ``rgb`` [B, N, C]; a decode's rows are B * M
(M prompts a cloud), the cloud's tensors repeated M times.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

INF = float("inf")
FP8_MAX = 448.0  # largest finite float8_e4m3fn


def fp32_matmuls() -> None:
    """Full fp32 products on the card: TF32 off for cuBLAS and cuDNN. The
    reference's callers set it themselves, after the program is imported,
    so that no setting of the program's moves the yardstick."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Prec:
    """Where the reference rounds below fp32. ``net``: "fp32", or "fp8"
    (both operands of every product of the network rounded to float8 e4m3
    with one scale a tensor); ``geom``: "fp32", or "bf16" (the geometry's
    coordinates and squared distances in bfloat16)."""

    def __init__(self, net: str = "fp32", geom: str = "fp32"):
        if net not in ("fp32", "fp8") or geom not in ("fp32", "bf16"):
            raise ValueError(f"unknown precision net={net!r} geom={geom!r}")
        self.net, self.geom = net, geom

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` rounded to float8 e4m3 (one scale over the tensor)."""
        if self.net == "fp32":
            return x
        scale = x.abs().amax().clamp_min(1e-30) / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).float() * scale

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.q(a), self.q(b))


FP32 = Prec()


# ------------------------------------------------------------------ geometry
def _fma(a, b, c):
    """fp32 fma(a, b, c), rounded once: the product of two fp32 values is
    exact in fp64; TwoSum recovers the sum's error, which decides the
    midpoint cases a plain fp64 -> fp32 cast would round twice."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    t = s - p
    e = (p - (s - t)) + (cd - t)
    r = s.float()
    gap = s - r.double()
    other = torch.nextafter(r, torch.where(gap > 0, INF, -INF))
    mid = (gap != 0) & (2.0 * gap == other.double() - r.double())
    return torch.where(mid & (e * gap > 0), other, r)


def _sq_norm(d: torch.Tensor, prec: Prec) -> torch.Tensor:
    """Squared norm over the last axis of 3: fma(dz, dz, fma(dx, dx, dy^2))
    in fp32 (the farthest-point loop's and the 3-NN weights' distance)."""
    if prec.geom == "bf16":
        d = d.bfloat16()
        return (d * d).sum(-1).float()
    dx, dz = d[..., 0].double(), d[..., 2].double()
    inner = (dx * dx + (d[..., 1] * d[..., 1]).double()).float()
    return (dz * dz + inner.double()).float()


def _dot3(a, b, prec: Prec):
    if prec.geom == "bf16":
        return (a.bfloat16() * b.bfloat16()).sum(-1).float()
    return _fma(a[..., 2], b[..., 2], _fma(a[..., 1], b[..., 1], a[..., 0] * b[..., 0]))


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, N, ...] at idx [B, ...] along N."""
    B = x.shape[0]
    flat = idx.reshape(B, -1).long()
    out = torch.stack([x[b].index_select(0, flat[b]) for b in range(B)])
    return out.reshape(*idx.shape, *x.shape[2:])


def fps(xyz: torch.Tensor, G: int, prec: Prec = FP32) -> torch.Tensor:
    """Farthest point sampling from point 0: [B, N, 3] -> [B, G] indices
    (the first among equal maxima)."""
    xyz = xyz.float()
    B, N, _ = xyz.shape
    ar = torch.arange(B, device=xyz.device)
    sel = torch.zeros(B, dtype=torch.long, device=xyz.device)
    min_d = torch.full((B, N), INF, device=xyz.device)
    out = []
    for g in range(G):
        out.append(sel)
        min_d = torch.minimum(min_d, _sq_norm(xyz - xyz[ar, sel][:, None, :], prec))
        if g + 1 < G:
            sel = min_d.argmax(1)
    return torch.stack(out, 1)


def interp3(xyz: torch.Tensor, centers: torch.Tensor, prec: Prec = FP32,
            chunk_pairs: int = 1 << 23) -> tuple[torch.Tensor, torch.Tensor]:
    """Each point's 3 nearest centres (ascending, first index among equal
    distances) and their weights 1 / max(d^2, 1e-8), normalised.
    Returns (idx [B, N, 3], weight [B, N, 3])."""
    idxs, ds = [], []
    tile = max(1, chunk_pairs // (centers.shape[0] * centers.shape[1]))
    for s in range(0, xyz.shape[1], tile):
        d2 = _sq_norm(xyz[:, s:s + tile, None, :].float() - centers[:, None, :, :].float(), prec)
        td, ti = [], []
        for j in range(3):
            d, i = d2.min(-1)
            td.append(d)
            ti.append(i)
            if j < 2:
                d2 = d2.scatter(-1, i[..., None], INF)
        ds.append(torch.stack(td, -1))
        idxs.append(torch.stack(ti, -1))
    inv = 1.0 / torch.cat(ds, 1).clamp_min(1e-8)
    return torch.cat(idxs, 1), inv / inv.sum(-1, keepdim=True)


def geometry(kind, xyz: torch.Tensor, G: int, K: int | None, prec: Prec = FP32) -> dict:
    """The tokenizer's geometry of each cloud: FPS centres, the kind's
    groups (``kind.groups``), and the 3-NN interpolation onto the centres."""
    with torch.no_grad():
        fps_idx = fps(xyz, G, prec)
        centers = gather_rows(xyz.float(), fps_idx)
        geom = dict(fps_idx=fps_idx, centers=centers)
        geom.update(kind.groups(xyz, centers, K, prec))
        geom["interp_idx"], geom["interp_w"] = interp3(xyz, centers, prec)
    return geom


# ------------------------------------------------------------------ layers
def linear(P: dict, name: str, x: torch.Tensor, prec: Prec, bias: bool = True):
    y = prec.mm(x, P[name + ".weight"].t())
    return y + P[name + ".bias"] if bias else y


def layer_norm(P: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), P[name + ".weight"], P[name + ".bias"], 1e-5)


def gelu(x):
    return F.gelu(x)


def attention_heads(q, k, v, heads: int, prec: Prec):
    """softmax(q k^T / sqrt(dh)) v over ``heads`` heads of [B, S, D]."""
    B, Sq, D = q.shape
    Sk = k.shape[1]
    dh = D // heads
    q = q.reshape(B, Sq, heads, dh).transpose(1, 2)
    k = k.reshape(B, Sk, heads, dh).transpose(1, 2)
    v = v.reshape(B, Sk, heads, dh).transpose(1, 2)
    p = torch.softmax(prec.mm(q, k.transpose(-1, -2)) / math.sqrt(dh), -1)
    return prec.mm(p, v).transpose(1, 2).reshape(B, Sq, D)


# ------------------------------------------------------------------ encoder
def vit_block(P: dict, name: str, x: torch.Tensor, vit: dict, prec: Prec) -> torch.Tensor:
    """One EVA block: pre-LN attention and MLP, each residual."""
    h = layer_norm(P, name + ".norm1", x)
    a = name + ".attn"
    if vit["qkv_fused"]:
        bias = torch.cat([P[a + ".q_bias"], torch.zeros_like(P[a + ".q_bias"]), P[a + ".v_bias"]])
        q, k, v = (prec.mm(h, P[a + ".qkv.weight"].t()) + bias).chunk(3, -1)
    else:
        q = linear(P, a + ".q_proj", h, prec)
        k = linear(P, a + ".k_proj", h, prec, bias=False)
        v = linear(P, a + ".v_proj", h, prec)
    x = x + linear(P, a + ".proj", attention_heads(q, k, v, vit["num_heads"], prec), prec)
    h = layer_norm(P, name + ".norm2", x)
    m = name + ".mlp"
    if vit["swiglu"]:
        h = F.silu(linear(P, m + ".fc1_g", h, prec)) * linear(P, m + ".fc1_x", h, prec)
        h = layer_norm(P, m + ".norm", h)
    else:
        h = gelu(linear(P, m + ".fc1", h, prec))
    return x + linear(P, m + ".fc2", h, prec)


def pos_encoding(P: dict, pts: torch.Tensor) -> torch.Tensor:
    """Random-Fourier encoding of coordinates: [..., 3] -> [..., 2 * 128]."""
    x = 2.0 * math.pi * (pts.float() @ P["point_encoder.pe_layer.positional_encoding_gaussian_matrix"])
    return torch.cat([torch.sin(x), torch.cos(x)], -1)


def encode(P: dict, kind, vit: dict, xyz, rgb, geom: dict, prec: Prec = FP32):
    """(cloud embeddings [B, G, 256], their positional encoding [B, G, 256])."""
    centers = geom["centers"]
    x = linear(P, "pc_encoder.patch_proj", kind.patch_embed(P, xyz, rgb, geom, prec), prec)
    pos = gelu(linear(P, "pc_encoder.pos_embed.0", centers, prec))
    x = x + linear(P, "pc_encoder.pos_embed.2", pos, prec)
    for i in range(vit["depth"]):
        x = vit_block(P, f"pc_encoder.transformer.blocks.{i}", x, vit, prec)
    x = layer_norm(P, "pc_encoder.transformer.norm", x)
    return linear(P, "pc_encoder.out_proj", x, prec), pos_encoding(P, centers)


# ------------------------------------------------------------------ decoder
def prompt_tokens(P: dict, pts: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Click tokens [R, P, 256]: position encoding plus the positive or
    negative embedding."""
    pos = P["point_encoder.point_embeddings.1.weight"][0]
    neg = P["point_encoder.point_embeddings.0.weight"][0]
    return pos_encoding(P, pts) + torch.where(labels[..., None].bool(), pos, neg)


def mask_prompt(P: dict, kind, logits, xyz, geom: dict, rows: int, prec: Prec):
    """Dense prompt [R, G, 256] from the previous mask logits [R, N] (None:
    the learned no-mask embedding; else the kind's ``mask_prompt``).
    ``rows`` R = B * M."""
    if logits is None:
        return P["mask_encoder.no_mask_embed.weight"][0].expand(rows, geom["centers"].shape[1], -1)
    return kind.mask_prompt(P, logits.float(), xyz, geom, rows, prec)


def _attn(P: dict, name: str, q, k, v, heads: int, prec: Prec):
    q = linear(P, name + ".q_proj", q, prec)
    k = linear(P, name + ".k_proj", k, prec)
    v = linear(P, name + ".v_proj", v, prec)
    return linear(P, name + ".out_proj", attention_heads(q, k, v, heads, prec), prec)


def _mlp(P: dict, name: str, x, layers: int, prec: Prec):
    for i in range(layers):
        x = linear(P, f"{name}.layers.{i}", x, prec)
        if i < layers - 1:
            x = F.relu(x)
    return x


def decode(P: dict, kind, dec: dict, emb, pe, xyz, geom: dict, pts, labels, logits,
           multimask: bool, prec: Prec = FP32):
    """One decoder pass: the two-way transformer over the click tokens and
    the cloud tokens, the tokens' upscaling onto every point by the 3-NN
    weights, the hypernetwork dot product, the IoU head.

    emb, pe [B, G, 256]; pts [R, P, 3], labels [R, P]; logits [R, N] or
    None (R = B * M). Returns (mask logits [R, C, N], IoU predictions [R, C]),
    C = 3 with ``multimask`` else 1."""
    R = pts.shape[0]
    B = emb.shape[0]
    m = R // B
    heads = dec["num_heads"]
    t = "mask_decoder.transformer"
    out_tokens = torch.cat([P["mask_decoder.iou_token.weight"], P["mask_decoder.mask_tokens.weight"]])
    tokens = torch.cat([out_tokens.expand(R, -1, -1), prompt_tokens(P, pts, labels)], 1)
    keys = emb.repeat_interleave(m, 0) + mask_prompt(P, kind, logits, xyz, geom, R, prec)
    key_pe = pe.repeat_interleave(m, 0)
    queries = tokens
    for i in range(dec["depth"]):
        b = f"{t}.layers.{i}"
        if i == 0:
            queries = _attn(P, b + ".self_attn", queries, queries, queries, heads, prec)
        else:
            q = queries + tokens
            queries = queries + _attn(P, b + ".self_attn", q, q, queries, heads, prec)
        queries = layer_norm(P, b + ".norm1", queries)
        q, k = queries + tokens, keys + key_pe
        queries = layer_norm(P, b + ".norm2", queries + _attn(
            P, b + ".cross_attn_token_to_image", q, k, keys, heads, prec))
        h = linear(P, b + ".mlp.lin2", F.relu(linear(P, b + ".mlp.lin1", queries, prec)), prec)
        queries = layer_norm(P, b + ".norm3", queries + h)
        q, k = queries + tokens, keys + key_pe
        keys = layer_norm(P, b + ".norm4", keys + _attn(
            P, b + ".cross_attn_image_to_token", k, q, queries, heads, prec))
    q, k = queries + tokens, keys + key_pe
    queries = layer_norm(P, f"{t}.norm_final_attn", queries + _attn(
        P, f"{t}.final_attn_token_to_image", q, k, keys, heads, prec))

    sel = range(1, 4) if multimask else range(0, 1)
    hyper = torch.stack([_mlp(P, f"mask_decoder.output_hypernetworks_mlps.{i}",
                              queries[:, 1 + i], 3, prec) for i in sel], 1)
    # Upscaling: the cloud tokens interpolated onto every point, then
    # Dense-LN-GELU-Dense-GELU.
    idx, w = geom["interp_idx"], geom["interp_w"]
    x = (gather_rows(keys, idx.repeat_interleave(m, 0)) * w.repeat_interleave(m, 0)[..., None]).sum(-2)
    u = "mask_decoder.output_upscaling"
    x = gelu(layer_norm(P, u + ".1", linear(P, u + ".0", x, prec)))
    x = gelu(linear(P, u + ".3", x, prec))
    masks = prec.mm(hyper, x.transpose(1, 2))
    iou = _mlp(P, "mask_decoder.iou_prediction_head", queries[:, 0], 3, prec)[:, list(sel)]
    return masks, iou
