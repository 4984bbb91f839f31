"""Weights carried across from the JAX package (counterpart of
point_sam_tpu/utils/convert.py, inverted).

``state_dict_from_flax(variables)`` turns the JAX model's variables (a
nested dict of numpy arrays with ``params`` and ``buffers``) into this
port's state dict, whose keys are the reference's torch keys. It inverts
the JAX converter's rules: flax ``kernel`` [in, out] -> ``weight``
[out, in]; LayerNorm ``scale`` -> ``weight``; the scan-stacked
``blocks/block/...`` [depth, ...] leaves -> ``blocks.{i}....``;
``label_embed`` rows -> ``point_embeddings.{i}.weight``; ``no_mask_embed``
[D] -> [1, D].

The EVA-giant blocks: the fused ``attn/qkv/kernel`` becomes timm's
``attn.qkv.weight``, and the thirds of ``attn/qkv/bias`` become
``attn.q_bias`` and ``attn.v_bias``; timm has no k bias, so a non-zero k
third raises instead of being dropped.

The key table is this module's own (the port imports nothing of the JAX
package); the tests hold it against ``point_sam_tpu.utils.convert.map_torch_key``.
The JAX converter has no rules for the voronoi variant's ``PatchEmbedNN``
and ``MaskEncoderNN``; their torch keys follow the flax module names under
the port's module paths (``params/patch_embed/blocks1_0/fc1`` ->
``pc_encoder.patch_embed.blocks1_0.fc1``, ``params/mask_encoder/res_in``
-> ``mask_encoder.res_in``). Nor for the hier variant's: its two PointNets
keep their flax and reference names under the port's module paths
(``params/patch_embed/patch_encoder1/conv1/Dense_0`` ->
``pc_encoder.patch_embed.patch_encoder1.conv1.0``, the same under
``mask_encoder``), its decoder's upscaling stacks are nn.Sequential like
the flagship's ``output_upscaling`` (``output_upscaling2_fc1`` /
``_norm`` / ``_fc2`` -> ``mask_decoder.output_upscaling2.0`` / ``.1`` /
``.3``, likewise ``output_upscaling1``), and ``hyper_mlp_{i}`` maps to
``output_hypernetworks_mlps.{i}`` as in the flagship.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_PN = r"(conv[12])"
_PE = r"(patch_encoder[12]?)"  # the flagship's PointNet or a hier level's
# (flax module path, torch module prefix): a module's leaves follow
# kernel -> weight (transposed), bias -> bias, scale -> weight.
_MODULE_RULES = [
    (rf"params/patch_embed/{_PE}/{_PN}/Dense_0", r"pc_encoder.patch_embed.\1.\2.0"),
    (rf"params/patch_embed/{_PE}/{_PN}/LayerNorm_0/LayerNorm_0", r"pc_encoder.patch_embed.\1.\2.1"),
    (rf"params/patch_embed/{_PE}/{_PN}/Dense_1", r"pc_encoder.patch_embed.\1.\2.3"),
    (rf"params/mask_encoder/{_PE}/{_PN}/Dense_0", r"mask_encoder.\1.\2.0"),
    (rf"params/mask_encoder/{_PE}/{_PN}/LayerNorm_0/LayerNorm_0", r"mask_encoder.\1.\2.1"),
    (rf"params/mask_encoder/{_PE}/{_PN}/Dense_1", r"mask_encoder.\1.\2.3"),
    (r"params/pc_encoder/patch_proj", "pc_encoder.patch_proj"),
    (r"params/pc_encoder/pos_embed/Dense_0", "pc_encoder.pos_embed.0"),
    (r"params/pc_encoder/pos_embed/Dense_1", "pc_encoder.pos_embed.2"),
    (r"params/pc_encoder/transformer/blocks_(\d+)/(norm[12])/LayerNorm_0", r"pc_encoder.transformer.blocks.\1.\2"),
    (r"params/pc_encoder/transformer/blocks_(\d+)/attn/(q_proj|k_proj|v_proj|proj)", r"pc_encoder.transformer.blocks.\1.attn.\2"),
    (r"params/pc_encoder/transformer/blocks_(\d+)/attn/qkv", r"pc_encoder.transformer.blocks.\1.attn.qkv"),
    (r"params/pc_encoder/transformer/blocks_(\d+)/mlp/(fc1_g|fc1_x|fc1|fc2)", r"pc_encoder.transformer.blocks.\1.mlp.\2"),
    (r"params/pc_encoder/transformer/blocks_(\d+)/mlp/norm/LayerNorm_0", r"pc_encoder.transformer.blocks.\1.mlp.norm"),
    (r"params/pc_encoder/transformer/norm/LayerNorm_0", "pc_encoder.transformer.norm"),
    (r"params/pc_encoder/out_proj", "pc_encoder.out_proj"),
    (r"params/mask_decoder/transformer/layers_(\d+)/self_attn/(\w+_proj)", r"mask_decoder.transformer.layers.\1.self_attn.\2"),
    (r"params/mask_decoder/transformer/layers_(\d+)/cross_attn_token_to_pc/(\w+_proj)", r"mask_decoder.transformer.layers.\1.cross_attn_token_to_image.\2"),
    (r"params/mask_decoder/transformer/layers_(\d+)/cross_attn_pc_to_token/(\w+_proj)", r"mask_decoder.transformer.layers.\1.cross_attn_image_to_token.\2"),
    (r"params/mask_decoder/transformer/layers_(\d+)/(norm[1-4])/LayerNorm_0", r"mask_decoder.transformer.layers.\1.\2"),
    (r"params/mask_decoder/transformer/layers_(\d+)/mlp/Dense_0", r"mask_decoder.transformer.layers.\1.mlp.lin1"),
    (r"params/mask_decoder/transformer/layers_(\d+)/mlp/Dense_1", r"mask_decoder.transformer.layers.\1.mlp.lin2"),
    (r"params/mask_decoder/transformer/final_attn_token_to_pc/(\w+_proj)", r"mask_decoder.transformer.final_attn_token_to_image.\1"),
    (r"params/mask_decoder/transformer/norm_final_attn/LayerNorm_0", "mask_decoder.transformer.norm_final_attn"),
    (r"params/mask_decoder/output_upscaling/Dense_0", "mask_decoder.output_upscaling.0"),
    (r"params/mask_decoder/output_upscaling/LayerNorm_0/LayerNorm_0", "mask_decoder.output_upscaling.1"),
    (r"params/mask_decoder/output_upscaling/Dense_1", "mask_decoder.output_upscaling.3"),
    (r"params/mask_decoder/hyper_mlp_(\d+)/Dense_(\d+)", r"mask_decoder.output_hypernetworks_mlps.\1.layers.\2"),
    (r"params/mask_decoder/iou_prediction_head/Dense_(\d+)", r"mask_decoder.iou_prediction_head.layers.\1"),
    # Voronoi variant (no JAX converter rules: flax module names).
    (r"params/patch_embed/(in_proj|out_proj)", r"pc_encoder.patch_embed.\1"),
    (r"params/patch_embed/(blocks[12]_\d+)/(fc1|fc2)", r"pc_encoder.patch_embed.\1.\2"),
    (r"params/patch_embed/(blocks[12]_\d+)/(norm|mid_norm)/LayerNorm_0", r"pc_encoder.patch_embed.\1.\2"),
    (r"params/patch_embed/norm/LayerNorm_0", "pc_encoder.patch_embed.norm"),
    (r"params/mask_encoder/(first_nn|res_in|res_\d|res_out)", r"mask_encoder.\1"),
    (r"params/mask_encoder/(res_in_norm|res_\d_norm)/LayerNorm_0", r"mask_encoder.\1"),
    # Hier variant (no JAX converter rules either).
    (r"params/mask_decoder/(output_upscaling[12])_fc1", r"mask_decoder.\1.0"),
    (r"params/mask_decoder/(output_upscaling[12])_norm/LayerNorm_0", r"mask_decoder.\1.1"),
    (r"params/mask_decoder/(output_upscaling[12])_fc2", r"mask_decoder.\1.3"),
]
_MODULE_RULES = [(re.compile(p + "$"), t) for p, t in _MODULE_RULES]
_LEAF = {"kernel": "weight", "bias": "bias", "scale": "weight"}

# Whole leaves with their own key (and shape) rules.
_LEAF_RULES = {
    "buffers/point_encoder/pe_layer/gaussian_matrix":
        "point_encoder.pe_layer.positional_encoding_gaussian_matrix",
    "params/mask_encoder/no_mask_embed": "mask_encoder.no_mask_embed.weight",
    "params/mask_decoder/iou_token": "mask_decoder.iou_token.weight",
    "params/mask_decoder/mask_tokens": "mask_decoder.mask_tokens.weight",
}
_LABEL_EMBED = "params/point_encoder/label_embed"
# The thirds of a fused qkv bias (``.../attn/qkv/q_bias`` names the q third).
_QKV_BIAS = re.compile(r"params/pc_encoder/transformer/blocks_(\d+)/attn/qkv/(q_bias|v_bias)$")
_STACKED = re.compile(r"(.*)/blocks/block/(.*)")
_INDEXED = re.compile(r"(.*)\[(\d+)\]$")


def torch_key_for(flax_path: str) -> str:
    """Torch state-dict key of one flax leaf path (unrolled block layout
    ``blocks_{i}``; ``label_embed[i]`` names row i of the label table)."""
    m = _INDEXED.match(flax_path)
    if m and m.group(1) == _LABEL_EMBED:
        return f"point_encoder.point_embeddings.{m.group(2)}.weight"
    if flax_path in _LEAF_RULES:
        return _LEAF_RULES[flax_path]
    m = _QKV_BIAS.match(flax_path)
    if m:
        return f"pc_encoder.transformer.blocks.{m.group(1)}.attn.{m.group(2)}"
    module, _, leaf = flax_path.rpartition("/")
    for pat, tmpl in _MODULE_RULES:
        mm = pat.match(module)
        if mm and leaf in _LEAF:
            return f"{mm.expand(tmpl)}.{_LEAF[leaf]}"
    raise KeyError(f"no torch key for flax leaf {flax_path!r}")


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def state_dict_from_flax(variables) -> dict[str, torch.Tensor]:
    """The port's state dict from the JAX package's variables.

    Args:
        variables: nested dict (``params`` and ``buffers``) of arrays, as
            ``point_sam_tpu.models.init_variables`` returns (scan-stacked
            or unrolled ViT blocks).

    Returns:
        dict torch key -> fp32 CPU tensor, ready for ``load_state_dict``.
    """
    flat = {}
    for path, arr in _flatten(variables).items():
        m = _STACKED.match(path)
        if m:
            for i in range(arr.shape[0]):
                flat[f"{m.group(1)}/blocks_{i}/{m.group(2)}"] = arr[i]
        else:
            flat[path] = arr
    sd = {}
    for path, arr in flat.items():
        arr = np.asarray(arr, np.float32)
        if path == _LABEL_EMBED:
            for i in range(arr.shape[0]):
                sd[torch_key_for(f"{path}[{i}]")] = arr[i][None]
            continue
        if path.endswith("/attn/qkv/bias"):  # [q | k | v] thirds of a fused bias
            d = arr.shape[0] // 3
            if np.any(arr[d:2 * d] != 0):
                raise ValueError(f"{path}: the k third of a fused qkv bias is not zero, "
                                 "and timm's layout has no k bias to carry it")
            base = path[:-len("/bias")]
            sd[torch_key_for(f"{base}/q_bias")] = arr[:d]
            sd[torch_key_for(f"{base}/v_bias")] = arr[2 * d:]
            continue
        if path == "params/mask_encoder/no_mask_embed":
            arr = arr[None]
        elif path.endswith("/kernel"):
            arr = arr.T
        sd[torch_key_for(path)] = arr
    return {k: torch.from_numpy(np.array(v, np.float32, order="C")) for k, v in sd.items()}
