"""Models of the PyTorch port (counterpart of point_sam_tpu/models)."""

from .decoder_variants import PatchDropout, Propagate, PropagateAttn, PropagateNN
from .loss import compute_iou, compute_jaccard, compute_mask_loss, criterion
from .layers import GELU, MLP, CoordMLP, Dense, Embedding, LayerNorm, MLPBlock, PointNetLayer
from .mask_decoder import MaskDecoder, OutputUpscaling, TwoWayDecoderTrunk
from .patch_encoder import PatchEncoder, PatchEncoderNN
from .pc_encoder import PatchEmbed, PatchEmbedHier, PatchEmbedNN, PointCloudEncoder, PreLNBlock
from .pc_sam import (
    PointCloudSAM,
    PointSAMConfig,
    cast_params_for_inference,
    for_inference,
    for_sharded_eval,
)
from .pc_sam_variants import (
    HierConfig,
    MaskDecoderHier,
    PointCloudSAMHier,
    PointCloudSAMNN,
    VoronoiConfig,
)
from .prompt_encoder import (
    MaskEncoder,
    MaskEncoderHier,
    MaskEncoderNN,
    PointEncoder,
    PositionEmbeddingRandom,
    PromptEncoderNN,
    mask_group_rel_xyz,
    mask_nbr_dist,
)
from .tokenizer import (
    HierTokenizerConfig,
    TokenizerConfig,
    compute_geometry,
    compute_geometry_hier,
    compute_geometry_voronoi,
)
from .transformer import Attention, TwoWayAttentionBlock, TwoWayTransformer
from .vit import VIT_PRESETS, EvaBlock, ViT, ViTConfig, get_vit_config

__all__ = [
    "Attention", "CoordMLP", "Dense", "Embedding", "EvaBlock", "GELU", "HierConfig",
    "HierTokenizerConfig", "LayerNorm", "MLP", "MLPBlock", "MaskDecoder", "MaskDecoderHier",
    "MaskEncoder", "MaskEncoderHier", "MaskEncoderNN", "OutputUpscaling", "PatchDropout",
    "PatchEmbed", "PatchEmbedHier", "PatchEmbedNN", "PatchEncoder", "PatchEncoderNN",
    "PointCloudEncoder", "PointCloudSAM", "PointCloudSAMHier", "PointCloudSAMNN", "PointEncoder",
    "PointNetLayer", "PointSAMConfig", "PositionEmbeddingRandom", "PreLNBlock",
    "PromptEncoderNN", "Propagate", "PropagateAttn", "PropagateNN", "TokenizerConfig",
    "TwoWayAttentionBlock", "TwoWayDecoderTrunk", "TwoWayTransformer", "VIT_PRESETS", "ViT",
    "ViTConfig", "VoronoiConfig", "cast_params_for_inference", "compute_geometry", "compute_geometry_hier",
    "compute_geometry_voronoi", "compute_iou", "compute_jaccard", "compute_mask_loss",
    "criterion", "for_inference", "for_sharded_eval", "get_vit_config", "mask_group_rel_xyz",
    "mask_nbr_dist",
]
