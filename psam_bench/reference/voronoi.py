"""The voronoi model kind (``"kind": "voronoi"`` in a configuration): each
point assigned to its nearest FPS centre, a per-point MLP max-pooled onto
the centres, and a mask prompt pooled the same way. The pieces the
benchmark needs of a kind are those ``reference/knn.py`` lists.

Plain PyTorch; nothing of the program is imported.
"""

from __future__ import annotations

import torch

from psam_bench.reference.model import FP32, INF, Prec, gather_rows, gelu, layer_norm, linear

GROUPS = "nn_idx"


def nearest_centre(xyz: torch.Tensor, centers: torch.Tensor, prec: Prec = FP32,
                   chunk_pairs: int = 1 << 26) -> torch.Tensor:
    """Each point's nearest centre (the voronoi assignment), first index
    among equal minima, by the |p|^2 - 2 p.c + |c|^2 expansion with the
    cross term a full-fp32 product. [B, N, 3] x [B, G, 3] -> [B, N]."""
    if prec.geom == "bf16":
        xyz, centers = xyz.bfloat16(), centers.bfloat16()
    c2 = centers.square().sum(-1)[:, None, :]
    chunk = max(1, chunk_pairs // (centers.shape[0] * centers.shape[1]))
    out = []
    for s in range(0, xyz.shape[1], chunk):
        p = xyz[:, s:s + chunk]
        d2 = p.square().sum(-1, keepdim=True) - 2.0 * torch.matmul(p, centers.transpose(1, 2)) + c2
        out.append(d2.clamp_min(0).float().argmin(-1))
    return torch.cat(out, 1)


def groups(xyz: torch.Tensor, centers: torch.Tensor, K, prec: Prec = FP32) -> dict:
    return {GROUPS: nearest_centre(xyz.float(), centers, prec)}


def program_groups(geom: dict, n: int) -> torch.Tensor:
    """The program's centre of each of the ``n`` real points of its one
    (padded) cloud."""
    return geom[GROUPS][0, :n]


def scatter_max(x: torch.Tensor, idx: torch.Tensor, L: int) -> torch.Tensor:
    """[B, N, C] per-point values -> [B, L, C] each segment's max, 0 where
    a segment holds no point."""
    B, N, C = x.shape
    out = torch.full((B, L, C), -INF, dtype=x.dtype, device=x.device)
    out = out.scatter_reduce(1, idx.long()[..., None].expand(B, N, C), x, "amax")
    return out.masked_fill(torch.isneginf(out), 0.0)


def patch_embed(P: dict, xyz, rgb, geom: dict, prec: Prec) -> torch.Tensor:
    """Patch embeddings [B, G, 512]: residual MLP blocks over every point
    (its unit offset from its centre, the distance, colours), max-pooled
    onto the centres, more blocks there."""
    pre = "pc_encoder.patch_embed"
    nn_idx, centers = geom[GROUPS], geom["centers"]
    off = xyz.float() - gather_rows(centers, nn_idx)
    dist = off.norm(dim=-1, keepdim=True)
    x = linear(P, pre + ".in_proj", torch.cat([off / dist.clamp_min(1e-8), dist, rgb.float()], -1),
               prec)

    def block(b, h):
        r = gelu(linear(P, b + ".fc1", layer_norm(P, b + ".norm", h), prec))
        return h + linear(P, b + ".fc2", layer_norm(P, b + ".mid_norm", r), prec)

    for i in range(3):
        x = block(f"{pre}.blocks1_{i}", x)
    y = scatter_max(x, nn_idx, centers.shape[1])
    for i in range(3):
        y = block(f"{pre}.blocks2_{i}", y)
    return linear(P, pre + ".out_proj", layer_norm(P, pre + ".norm", y), prec)


def mask_prompt(P: dict, logits, xyz, geom: dict, rows: int, prec: Prec) -> torch.Tensor:
    """Dense prompt [R, G, 256]: the previous logits with each point's
    offset, one Dense max-pooled onto the centres, residual blocks."""
    nn_idx, centers = geom[GROUPS], geom["centers"]
    m = rows // centers.shape[0]
    off = xyz.float() - gather_rows(centers, nn_idx)
    feats = torch.cat([logits[..., None], off.repeat_interleave(m, 0),
                       off.norm(dim=-1, keepdim=True).repeat_interleave(m, 0)], -1)
    y = scatter_max(linear(P, "mask_encoder.first_nn", feats, prec),
                    nn_idx.repeat_interleave(m, 0), centers.shape[1])
    h = gelu(layer_norm(P, "mask_encoder.res_in_norm", linear(P, "mask_encoder.res_in", y, prec)))
    for i in range(3):
        r = layer_norm(P, f"mask_encoder.res_{i}_norm", linear(P, f"mask_encoder.res_{i}", h, prec))
        h = h + gelu(r)
    return linear(P, "mask_encoder.res_out", h, prec)


def embed_flops(cfg: dict, B: int, n_points: int, G: int, K) -> float:
    hd, pc = cfg["tokenizer"]["hidden_dim"], cfg["patch_embed_channels"]
    return float(2 * B * n_points * (4 + cfg["in_channels"]) * hd + 3 * 4 * B * n_points * hd * hd
                 + 3 * 4 * B * G * hd * hd + 2 * B * G * hd * pc)


def mask_prompt_flops(cfg: dict, R: int, N: int, G: int, K) -> float:
    hm = cfg["mask_hidden_dim"]
    return float(2 * R * N * 5 * hm + 4 * 2 * R * G * hm * hm + 2 * R * G * hm * cfg["embed_dim"])
