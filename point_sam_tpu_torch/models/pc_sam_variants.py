"""The voronoi and hier Point-SAM variants (counterpart of
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

``PointCloudSAMHier`` is the reference's hierarchical model
(pc_sam.py:377-496): a two-level tokenizer (``PatchEmbedHier``), the ViT
over the level-2 patches, a two-level mask encoder (``MaskEncoderHier``)
and a decoder that upscales in two stages (``MaskDecoderHier``): the G2
tokens onto the G1 centres with the level-1 embeddings concatenated, then
the G1 tokens onto every point through the decoder tail (kernel K4 at the
default G1 = 2048, the gather and kernel K11 where K4's gate fails).

Both train (``forward``: the flagship's click loop, with the fixed
sampler for ``PointCloudSAMNN`` and the random one for
``PointCloudSAMHier``, as JAX's; the ViT blocks recomputed in the backward
by default, as JAX's ``vit_remat``). In the hier model the level-1
embeddings feed level 2's PointNet and every decode, so their gradient
reaches level 1 through kernel K7's dx.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..ops import decoder_tail, interpolate_features_repeated, repeat_interleave
from .layers import GELU, MLP, Dense, LayerNorm
from .mask_decoder import MaskDecoder, OutputUpscaling, TwoWayDecoderTrunk
from .pc_encoder import PatchEmbedHier, PatchEmbedNN, PointCloudEncoder
from .pc_sam import PointCloudSAM, _click_loop
from .prompt_encoder import (
    MaskEncoderHier,
    MaskEncoderNN,
    PointEncoder,
    mask_group_rel_xyz,
    mask_nbr_dist,
)
from .tokenizer import HierTokenizerConfig, compute_geometry_hier, compute_geometry_voronoi
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
    # Recompute each ViT block in the backward (JAX's default); no effect
    # without a gradient, and the parameters are the same either way.
    vit_remat: bool = True

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
            patch_embed=patch_embed, vit_remat=cfg.vit_remat, **kw)
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

    # Training / evaluation forward with simulated clicks (JAX
    # ``PointCloudSAMNN.__call__``): the flagship's, over this model's
    # geometry, encode, prompt cache and decode.
    forward = PointCloudSAM.forward
    click_sampler = "fixed"


# ------------------------------------------------------------------ hier
@dataclasses.dataclass(frozen=True)
class HierConfig:
    """Hier model hyperparameters (reference configs/model/hier.yaml)."""

    vit: str | ViTConfig = "eva02_large"
    tokenizer: HierTokenizerConfig = HierTokenizerConfig()
    embed_dim: int = 256
    patch_embed_channels: int = 512
    num_multimask_outputs: int = 3
    decoder_depth: int = 2
    decoder_num_heads: int = 8
    decoder_mlp_dim: int = 2048
    prompt_iters: int = 8
    enable_mask_refinement_iterations: bool = True
    vit_remat: bool = True  # as VoronoiConfig.vit_remat

    @property
    def vit_cfg(self) -> ViTConfig:
        return get_vit_config(self.vit) if isinstance(self.vit, str) else self.vit


class MaskDecoderHier(TwoWayDecoderTrunk):
    """Two-stage upscaling decoder (reference mask_decoder.py:214-370).

    After the two-way transformer over the G2 tokens:

    - stage 2 -> 1: a plain 3-NN gather of the tokens onto the G1 centres,
      the level-1 embeddings concatenated (D + ``encoder_dim`` channels),
      then ``output_upscaling2`` (Dense -> LN -> GELU -> Dense);
    - stage 1 -> points: ``output_upscaling1``'s first Dense (D -> D/2) on
      the G1 side (the 3-NN weights sum to 1, so it commutes with the
      interpolation), then ``ops.decoder_tail`` with its LN, its second
      Dense and the hypernetworks' D/2-wide rows.

    The interp weights are stop-gradient geometry. Keys: ``output_upscaling2``
    and ``output_upscaling1`` as nn.Sequential (``0`` / ``1`` / ``3``, as the
    flagship's ``output_upscaling``), ``output_hypernetworks_mlps.{i}``; the
    flax names are ``output_upscaling{2,1}_{fc1,norm,fc2}`` and
    ``hyper_mlp_{i}``."""

    def __init__(self, transformer_dim: int = 256, encoder_dim: int = 128,
                 num_multimask_outputs: int = 3, iou_head_depth: int = 3,
                 iou_head_hidden_dim: int = 256, depth: int = 2, num_heads: int = 8,
                 mlp_dim: int = 2048, *, dtype=torch.float32, device=None, generator=None):
        kw = dict(dtype=dtype, device=device, generator=generator)
        super().__init__(transformer_dim, num_multimask_outputs, iou_head_depth,
                         iou_head_hidden_dim, depth, num_heads, mlp_dim, **kw)
        D = transformer_dim
        self.output_upscaling2 = nn.Sequential(
            Dense(D + encoder_dim, D, **kw), LayerNorm(D, dtype=dtype, device=device), GELU(),
            Dense(D, D, **kw))
        self.output_upscaling1 = OutputUpscaling(D, D // 2, **kw)
        self.output_hypernetworks_mlps = nn.ModuleList(
            MLP(D, D, D // 2, 3, **kw) for _ in range(self.num_mask_tokens))

    def forward(self, pc_embeddings, pc_pe, sparse_prompt_embeddings,
                dense_prompt_embeddings, *, geom: dict, embeddings_l1,
                prompt_valid=None, multimask_output: bool = True):
        """pc_embeddings / pc_pe [B, G2, D]; embeddings_l1 [B, G1, 128]; geom
        from ``compute_geometry_hier`` -> (masks [B*M, C, N] fp32, iou_pred
        [B*M, C] fp32)."""
        hs, src = self.two_way(pc_embeddings, pc_pe, sparse_prompt_embeddings,
                               dense_prompt_embeddings, prompt_valid)
        BM = src.shape[0]
        mask_tokens_out = hs[:, 1:1 + self.num_mask_tokens]
        x = interpolate_features_repeated(src, geom["interp_index_21"],
                                          geom["interp_weight_21"].detach())  # [BM, G1, D]
        e1 = repeat_interleave(embeddings_l1.to(x.dtype), BM // embeddings_l1.shape[0], axis=0)
        x = self.output_upscaling2(torch.cat([x, e1], dim=-1))
        x = self.output_upscaling1[0](x)  # [BM, G1, D/2]: Dense hoisted to the G1 side
        token_slice = self.token_slice(multimask_output)
        hyper_in = torch.stack(
            [self.output_hypernetworks_mlps[i](mask_tokens_out[:, i]) for i in token_slice],
            dim=1)  # [BM, C, D/2]
        masks = decoder_tail(x, geom["interp_index"], geom["interp_weight"],
                             self.output_upscaling1.tail_params(), hyper_in, cdt=self.dtype)
        return masks, self.iou(hs, token_slice)


class PointCloudSAMHier(nn.Module):
    """Hierarchical Point-SAM (reference pc_sam.py:377-496)."""

    click_sampler = "random"

    def __init__(self, cfg: HierConfig, *, dtype=torch.float32, in_channels: int = 3,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        kw = dict(dtype=dtype, device=device, generator=generator)
        patch_embed = PatchEmbedHier(cfg.tokenizer, in_channels, cfg.patch_embed_channels, **kw)
        self.pc_encoder = PointCloudEncoder(
            cfg.vit_cfg, embed_dim=cfg.embed_dim, patch_embed_channels=cfg.patch_embed_channels,
            patch_embed=patch_embed, vit_remat=cfg.vit_remat, **kw)
        self.point_encoder = PointEncoder(cfg.embed_dim, **kw)
        self.mask_encoder = MaskEncoderHier(cfg.embed_dim, radius=cfg.tokenizer.radius, **kw)
        self.mask_decoder = MaskDecoderHier(
            cfg.embed_dim, num_multimask_outputs=cfg.num_multimask_outputs,
            depth=cfg.decoder_depth, num_heads=cfg.decoder_num_heads,
            mlp_dim=cfg.decoder_mlp_dim, **kw)

    @property
    def default_grouping(self) -> tuple[tuple[int, int], tuple[int, int]]:
        """((G1, G2), (K1, K2)) of the model's tokenizer."""
        return tuple(self.cfg.tokenizer.num_patches), tuple(self.cfg.tokenizer.patch_size)

    def make_geometry(self, coords, *, point_valid=None, group_number=None,
                      group_size=None) -> dict:
        """Two-level geometry; serving may override (G1, G2) and (K1, K2)."""
        tok = self.cfg.tokenizer
        tok = dataclasses.replace(tok, num_patches=tuple(group_number or tok.num_patches),
                                  patch_size=tuple(group_size or tok.patch_size))
        return compute_geometry_hier(coords, tok, point_valid=point_valid)

    def prompt_cache(self, coords, geom) -> dict:
        """The click-invariant half of both levels' mask-prompt grouping,
        cached in ``geom`` once per cloud (radius per level)."""
        r = self.mask_encoder.radius
        return dict(
            mask_rel_xyz1=mask_group_rel_xyz(coords, geom["centers1"], geom["knn_idx1"],
                                             radius=r[0] if r else None),
            mask_rel_xyz2=mask_group_rel_xyz(geom["centers1"], geom["centers2"],
                                             geom["knn_idx2"], radius=r[1] if r else None))

    def encode(self, coords, features, geom):
        """Returns (pc_embeddings [B, G2, D], pc_pe [B, G2, D],
        embeddings_l1 [B, G1, 128]); every decode takes the third."""
        x1, x2 = self.pc_encoder.patch_embed(coords, features, geom)
        pc_embeddings = self.pc_encoder(x2, geom["centers2"])
        pc_pe = self.point_encoder.pe_layer(geom["centers2"])
        return pc_embeddings, pc_pe, x1

    def decode(self, pc_embeddings, pc_pe, coords, geom, embeddings_l1, prompt_coords,
               prompt_labels, prompt_masks=None, *, prompt_valid=None, multimask_output=True):
        """One decoder pass against cached embeddings (see
        ``PointCloudSAM.decode``), with the level-1 embeddings of ``encode``."""
        sparse = self.point_encoder(prompt_coords, prompt_labels)
        _, dense = self.mask_encoder(
            prompt_masks, coords, geom["centers1"], geom["knn_idx1"], geom["centers2"],
            geom["knn_idx2"], rel_xyz1=geom.get("mask_rel_xyz1"),
            rel_xyz2=geom.get("mask_rel_xyz2"))
        return self.mask_decoder(
            pc_embeddings, pc_pe, sparse, dense, geom=geom, embeddings_l1=embeddings_l1,
            prompt_valid=prompt_valid, multimask_output=multimask_output)

    def predict_masks(self, coords, features, prompt_coords, prompt_labels,
                      prompt_masks=None, *, prompt_valid=None, point_valid=None,
                      multimask_output=True):
        """Encode + one decode."""
        geom = self.make_geometry(coords, point_valid=point_valid)
        pc_embeddings, pc_pe, x1 = self.encode(coords, features, geom)
        return self.decode(pc_embeddings, pc_pe, coords, geom, x1, prompt_coords,
                           prompt_labels, prompt_masks, prompt_valid=prompt_valid,
                           multimask_output=multimask_output)

    def forward(self, coords, features, gt_masks, *, is_eval: bool = False,
                point_valid=None, generator: torch.Generator | None = None,
                rows: tuple[int, int] | None = None):
        """Training / evaluation forward with simulated clicks (JAX
        ``PointCloudSAMHier.__call__``): the geometry, one encode, the
        prompt cache once, then the click loop with the random sampler and
        the level-1 embeddings in every decode. Arguments and returns as
        ``PointCloudSAM.forward``, but ``generator`` is needed always: it
        also seeds the sampler's noise."""
        geom = self.make_geometry(coords, point_valid=point_valid)
        pc_embeddings, pc_pe, x1 = self.encode(coords, features, geom)
        geom.update(self.prompt_cache(coords, geom))
        return _click_loop(self, pc_embeddings, pc_pe, coords, geom, gt_masks, is_eval=is_eval,
                           point_valid=point_valid, generator=generator,
                           sampler=self.click_sampler, decode_extra=dict(embeddings_l1=x1),
                           rows=rows)
