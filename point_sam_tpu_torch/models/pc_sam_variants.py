"""The voronoi Point-SAM variant (counterpart of the voronoi half of
point_sam_tpu/models/pc_sam_variants.py).

``PointCloudSAMNN`` is the reference's voronoi-tokenizer model
(pc_sam.py:199-374): every point is assigned to its nearest FPS centre,
the patch embed is a per-point MLP with a segment max onto the centres
(``PatchEmbedNN``), and the mask prompt encoder is a segment-max MLP
(``MaskEncoderNN``). The ViT, click encoder and mask decoder are the
flagship model's.

The segment count is taken from the geometry, not from
``cfg.num_patches``: a per-scene G (the Predictor's N > 30000 -> 2048 rule)
embeds every centre, as the reference does by rebuilding its grouper per
scene. The JAX package scatters onto ``cfg.num_patches`` segments there and
raises (ROADMAP.md queue 3); wherever it answers, the two agree.

Only the inference API is ported (``make_geometry``, ``encode``,
``decode``, ``predict_masks``); the training forward and the hier variant
are later slices (ROADMAP.md queue 1).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from .mask_decoder import MaskDecoder
from .pc_encoder import PatchEmbedNN, PointCloudEncoder
from .prompt_encoder import MaskEncoderNN, PointEncoder, mask_nbr_dist
from .tokenizer import compute_geometry_voronoi
from .vit import ViTConfig, get_vit_config


@dataclasses.dataclass(frozen=True)
class VoronoiConfig:
    """Voronoi model hyperparameters (reference configs/model/voronoi*.yaml)."""

    vit: str | ViTConfig = "eva02_large"
    num_patches: int = 1024
    hidden_dim: int = 256  # per-point MLP width of the patch embed
    embed_dim: int = 256
    patch_embed_channels: int = 512
    num_multimask_outputs: int = 3
    decoder_depth: int = 2
    decoder_num_heads: int = 8
    decoder_mlp_dim: int = 2048
    prompt_iters: int = 5
    enable_mask_refinement_iterations: bool = True

    @property
    def vit_cfg(self) -> ViTConfig:
        return get_vit_config(self.vit) if isinstance(self.vit, str) else self.vit


class PointCloudSAMNN(nn.Module):
    """Voronoi-tokenizer Point-SAM (reference pc_sam.py:199-374)."""

    def __init__(self, cfg: VoronoiConfig, *, dtype=torch.float32, in_channels: int = 3,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        kw = dict(dtype=dtype, device=device, generator=generator)
        patch_embed = PatchEmbedNN(in_channels, cfg.hidden_dim, cfg.patch_embed_channels, **kw)
        self.pc_encoder = PointCloudEncoder(
            cfg.vit_cfg, embed_dim=cfg.embed_dim, patch_embed_channels=cfg.patch_embed_channels,
            patch_embed=patch_embed, **kw)
        self.point_encoder = PointEncoder(cfg.embed_dim, **kw)
        self.mask_encoder = MaskEncoderNN(cfg.embed_dim, **kw)
        self.mask_decoder = MaskDecoder(
            cfg.embed_dim, cfg.num_multimask_outputs, depth=cfg.decoder_depth,
            num_heads=cfg.decoder_num_heads, mlp_dim=cfg.decoder_mlp_dim, **kw)

    @property
    def default_grouping(self) -> tuple[int, None]:
        """(G centres, None): a voronoi cell has no fixed size."""
        return self.cfg.num_patches, None

    def make_geometry(self, coords, *, point_valid=None, group_number=None) -> dict:
        """Voronoi geometry; serving may override G per scene."""
        return compute_geometry_voronoi(coords, group_number or self.cfg.num_patches,
                                        point_valid=point_valid)

    def prompt_cache(self, coords, geom) -> dict:
        """The click-invariant half of the mask-prompt features, cached in
        ``geom`` once per cloud: each point's offset from its centre."""
        return dict(mask_nbr_dist=mask_nbr_dist(coords, geom["centers"], geom["nn_idx"]))

    def encode(self, coords, features, geom):
        """Returns (pc_embeddings [B, G, D], pc_pe [B, G, D])."""
        emb = self.pc_encoder.patch_embed(coords, features, geom)
        pc_embeddings = self.pc_encoder(emb, geom["centers"])
        pc_pe = self.point_encoder.pe_layer(geom["centers"])
        return pc_embeddings, pc_pe

    def decode(self, pc_embeddings, pc_pe, coords, geom, prompt_coords, prompt_labels,
               prompt_masks=None, *, prompt_valid=None, multimask_output=True):
        """One decoder pass against cached embeddings (see
        ``PointCloudSAM.decode``); the mask prompt goes through
        ``MaskEncoderNN`` with the cached ``mask_nbr_dist`` when the
        geometry carries it."""
        sparse = self.point_encoder(prompt_coords, prompt_labels)
        dense = self.mask_encoder(prompt_masks, coords, geom["centers"], geom["nn_idx"],
                                  geom.get("point_valid"), nbr_dist=geom.get("mask_nbr_dist"))
        return self.mask_decoder(
            pc_embeddings, pc_pe, sparse, dense,
            interp_index=geom["interp_index"], interp_weight=geom["interp_weight"],
            prompt_valid=prompt_valid, multimask_output=multimask_output)

    def predict_masks(self, coords, features, prompt_coords, prompt_labels,
                      prompt_masks=None, *, prompt_valid=None, point_valid=None,
                      multimask_output=True):
        """Encode + one decode."""
        geom = self.make_geometry(coords, point_valid=point_valid)
        pc_embeddings, pc_pe = self.encode(coords, features, geom)
        return self.decode(pc_embeddings, pc_pe, coords, geom, prompt_coords,
                           prompt_labels, prompt_masks, prompt_valid=prompt_valid,
                           multimask_output=multimask_output)

    def forward(self, *args, **kwargs):
        raise NotImplementedError(
            "training the voronoi variant is not ported yet (ROADMAP.md queue 1, "
            "voronoi training)")
