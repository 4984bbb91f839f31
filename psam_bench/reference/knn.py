"""The kNN model kind (``"kind": "knn"`` in a configuration): each FPS
centre's K nearest points, PointNet patches of them, and a PointNet mask
prompt over the same groups.

What the benchmark needs of a model kind, found by the kind's name:

- ``GROUPS``: the key of the kind's groups in a geometry dict;
- ``groups(xyz, centers, K, prec)``: the reference's groups;
- ``program_groups(geom, n)``: the same out of the program's geometry of
  one cloud of ``n`` real points;
- ``patch_embed`` and ``mask_prompt``: the reference's layers of the kind;
- ``embed_flops`` and ``mask_prompt_flops``: their products, as
  ``work.py`` counts the rest.

Plain PyTorch; nothing of the program is imported.
"""

from __future__ import annotations

import torch

from psam_bench.reference.model import FP32, Prec, _dot3, gather_rows, gelu, layer_norm, linear
from psam_bench.work import pe_work

GROUPS = "knn_idx"


def knn(centers: torch.Tensor, xyz: torch.Tensor, k: int, prec: Prec = FP32,
        chunk_pairs: int = 1 << 24) -> torch.Tensor:
    """The k nearest points of every centre, ascending by (d^2, index);
    d^2 = max((|q|^2 - 2 q.k) + |k|^2, +0) of fp32 FMA dot products.
    [B, G, 3] x [B, N, 3] -> [B, G, k]."""
    centers, xyz = centers.float(), xyz.float()
    B, G, _ = centers.shape
    N = xyz.shape[1]
    k2 = _dot3(xyz, xyz, prec)[:, None, :]
    index = torch.arange(N, device=xyz.device, dtype=torch.int64)
    step = max(1, chunk_pairs // (B * N))
    out = []
    for s in range(0, G, step):
        q = centers[:, s:s + step]
        q2 = _dot3(q, q, prec)[:, :, None]
        d2 = (q2 - 2.0 * _dot3(q[:, :, None, :], xyz[:, None, :, :], prec)) + k2
        d2 = torch.where(d2 > 0.0, d2, 0.0).float()
        keys = (d2.view(torch.int32).to(torch.int64) << 32) | index
        best = torch.topk(keys, k, dim=-1, largest=False, sorted=True).values
        out.append(best & 0xFFFFFFFF)
    return torch.cat(out, 1)


def groups(xyz: torch.Tensor, centers: torch.Tensor, K: int, prec: Prec = FP32) -> dict:
    return {GROUPS: knn(centers, xyz, K, prec)}


def program_groups(geom: dict, n: int) -> torch.Tensor:
    """The program's [G, K] neighbour indices of its one cloud."""
    return geom[GROUPS][0]


def pointnet(P: dict, name: str, x: torch.Tensor, prec: Prec) -> torch.Tensor:
    """The two-stage PointNet of a patch: [..., K, C_in] -> [..., C_out]
    (Dense-LN-GELU-Dense, max over K, [max, point] concat, again)."""
    def unit(pre, h):
        h = linear(P, pre + ".0", h, prec)
        h = gelu(layer_norm(P, pre + ".1", h))
        return linear(P, pre + ".3", h, prec)

    h = unit(name + ".conv1", x)
    pooled = h.amax(-2, keepdim=True).expand_as(h)
    h = unit(name + ".conv2", torch.cat([pooled, h], -1))
    return h.amax(-2)


def patch_embed(P: dict, xyz, rgb, geom: dict, prec: Prec) -> torch.Tensor:
    """Patch embeddings [B, G, 512]: the PointNet over each centre's
    neighbours (offsets from the centre, colours)."""
    idx, centers = geom[GROUPS], geom["centers"]
    rel = gather_rows(xyz.float(), idx) - centers[:, :, None, :]
    feats = torch.cat([rel, gather_rows(rgb.float(), idx)], -1)
    return pointnet(P, "pc_encoder.patch_embed.patch_encoder", feats, prec)


def mask_prompt(P: dict, logits, xyz, geom: dict, rows: int, prec: Prec) -> torch.Tensor:
    """Dense prompt [R, G, 256]: the PointNet over each centre's neighbours
    (offsets, the previous logits at them)."""
    idx, centers = geom[GROUPS], geom["centers"]
    m = rows // centers.shape[0]
    rel = (gather_rows(xyz.float(), idx) - centers[:, :, None, :]).repeat_interleave(m, 0)
    lg = gather_rows(logits[..., None], idx.repeat_interleave(m, 0))
    return pointnet(P, "mask_encoder.patch_encoder", torch.cat([rel, lg], -1), prec)


def embed_flops(cfg: dict, B: int, n_points: int, G: int, K: int) -> float:
    cin = 3 + cfg["in_channels"]
    return float(pe_work(B * G * K, B * G, cin, 128, 512, cfg["patch_embed_channels"], 2)[1])


def mask_prompt_flops(cfg: dict, R: int, N: int, G: int, K: int) -> float:
    return float(pe_work(R * G * K, R * G, 4, 128, 512, cfg["embed_dim"], 2)[1])
