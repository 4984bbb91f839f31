"""Models of the PyTorch port (counterpart of point_sam_tpu/models)."""

from .loss import compute_iou, compute_jaccard, compute_mask_loss, criterion
from .layers import GELU, MLP, CoordMLP, Dense, Embedding, LayerNorm, MLPBlock, PointNetLayer
from .mask_decoder import MaskDecoder, OutputUpscaling
from .patch_encoder import PatchEncoder
from .pc_encoder import PatchEmbed, PointCloudEncoder
from .pc_sam import PointCloudSAM, PointSAMConfig, cast_params_for_inference, for_inference
from .prompt_encoder import MaskEncoder, PointEncoder, PositionEmbeddingRandom, mask_group_rel_xyz
from .tokenizer import TokenizerConfig, compute_geometry
from .transformer import Attention, TwoWayAttentionBlock, TwoWayTransformer
from .vit import VIT_PRESETS, EvaBlock, ViT, ViTConfig, get_vit_config

__all__ = [
    "Attention", "CoordMLP", "Dense", "Embedding", "EvaBlock", "GELU", "LayerNorm", "MLP",
    "MLPBlock", "MaskDecoder", "MaskEncoder", "OutputUpscaling", "PatchEmbed", "PatchEncoder",
    "PointCloudEncoder", "PointCloudSAM", "PointEncoder", "PointNetLayer", "PointSAMConfig",
    "PositionEmbeddingRandom", "TokenizerConfig", "TwoWayAttentionBlock", "TwoWayTransformer",
    "VIT_PRESETS", "ViT", "ViTConfig", "cast_params_for_inference", "compute_geometry",
    "compute_iou", "compute_jaccard", "compute_mask_loss", "criterion",
    "for_inference", "get_vit_config", "mask_group_rel_xyz",
]
