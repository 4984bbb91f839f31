"""Weights carried into the port: the reference's torch checkpoints and the
JAX package's variables (counterpart of point_sam_tpu/utils/convert.py).

Reference checkpoints. The port's keys are the reference's, so
``load_reference_state_dict(model, sd)`` loads a released state dict
(``load_torch_safetensors`` reads one from a ``.safetensors`` file) almost
key for key, and triages every key as the JAX converter does
(``classify_unmapped``). What it translates: a fused timm
``attn.qkv.weight`` with ``attn.q_bias`` / ``attn.v_bias`` goes onto an
EVA02 model's ``q_proj`` / ``k_proj`` / ``v_proj`` in thirds (onto the
EVA-giant's own fused ``qkv`` as it is); ``pc_encoder.transformer.fc_norm``
is ``norm``. ``convert_uni3d`` does the reference's key surgery for Uni3D
encoder weights (train.py:101-121). The parity command

    python -m point_sam_tpu_torch.utils.convert --check model.safetensors \
        [--golden] [--config large] [--device cpu]

prints how every key fared and, with ``--golden``, each module's activation
diff between the numpy oracles of ``utils/golden.py`` on the raw weights
and the port's fp32 modules on the loaded ones (on the card unless
``--device`` names another device).

JAX variables.

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

A standalone module's variables convert the same way: the propagate
variants' and ``PatchEncoderNN``'s (``params/relative_mlp/Dense_0`` ->
``relative_mlp.0``, ``params/q_mlp/Dense_2`` -> ``q_mlp.layers.2``,
``params/res_0_norm/LayerNorm_0`` -> ``res_0_norm``,
``buffers/gaussian_matrix`` -> ``gaussian_matrix``), and
``PromptEncoderNN``'s, which are the voronoi model's ``point_encoder`` and
``mask_encoder`` leaves.
"""

from __future__ import annotations

import argparse
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
    (r"params/pc_encoder/transformer/blocks_(\d+)/attn/norm/LayerNorm_0", r"pc_encoder.transformer.blocks.\1.attn.norm"),
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
    # Standalone modules, variables at the root: the propagate variants
    # (models/decoder_variants.py) and PatchEncoderNN. Their Dense-LN-GELU-
    # Dense blocks are nn.Sequential as PointNetLayer is; q_mlp / k_mlp are
    # MLPs; PropagateNN's residual stack keeps the flax names.
    (r"params/(relative_mlp|mlp|fc|conv[12])/Dense_0", r"\1.0"),
    (r"params/(relative_mlp|mlp|fc|conv[12])/LayerNorm_0/LayerNorm_0", r"\1.1"),
    (r"params/(relative_mlp|mlp|fc|conv[12])/Dense_1", r"\1.3"),
    (r"params/([qk]_mlp)/Dense_(\d+)", r"\1.layers.\2"),
    (r"params/(res_in|res_\d+|res_out)", r"\1"),
    (r"params/(res_in_norm|res_\d+_norm)/LayerNorm_0", r"\1"),
]
_MODULE_RULES = [(re.compile(p + "$"), t) for p, t in _MODULE_RULES]
_LEAF = {"kernel": "weight", "bias": "bias", "scale": "weight"}

# Whole leaves with their own key (and shape) rules.
_LEAF_RULES = {
    "buffers/point_encoder/pe_layer/gaussian_matrix":
        "point_encoder.pe_layer.positional_encoding_gaussian_matrix",
    "params/mask_encoder/no_mask_embed": "mask_encoder.no_mask_embed.weight",
    "buffers/gaussian_matrix": "gaussian_matrix",  # PropagateNN's
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



# ------------------------------------------------- reference checkpoints
# The released checkpoint is the whole PointCloudSAM state dict, and its
# timm submodule (timm.create_model(name, pretrained=False), default
# num_classes) carries tensors the reference forward never runs
# (pc_encoder.py:118-143 bypasses timm's patch / pos embed, cls token and
# head; the blocks run without rope): ``recognized_unused``, dropped even
# by a strict load.
KNOWN_UNUSED = [re.compile(p + r"$") for p in (
    r"pc_encoder\.transformer\.cls_token",
    r"pc_encoder\.transformer\.pos_embed",
    r"pc_encoder\.transformer\.patch_embed\..*",
    r"pc_encoder\.transformer\.head\..*",
    r"pc_encoder\.transformer\.rope\..*",
    r"pc_encoder\.transformer\.mask_token",
)]

# timm EVA variant tensors that would change the numerics and that no
# module of the port holds: qk-norm, per-block layer scale. (``attn.norm``
# has a module, ``ViTConfig.attn_inner_norm``; it lands in
# ``variant_unsupported`` only when the model was built without it.)
KNOWN_VARIANT = [re.compile(p + r"$") for p in (
    r"pc_encoder\.transformer\.blocks\.\d+\.attn\.(q|k)_norm\..*",
    r"pc_encoder\.transformer\.blocks\.\d+\.gamma_[12]",
    r"pc_encoder\.transformer\.blocks\.\d+\.ls[12]\..*",
)]

# The reference's key surface for the kNN model (the torch side of the JAX
# converter's rule table). A key of it that the model lacks comes from a
# module variant the model was not built with: ``variant_unsupported``.
_B = r"pc_encoder\.transformer\.blocks\.\d+"
_L = r"mask_decoder\.transformer\.layers\.\d+"
_WB = r"\.(weight|bias)"
_ATTN = rf"(q_proj|k_proj|v_proj|out_proj){_WB}"
_SURFACE = [re.compile(p + r"$") for p in (
    rf"(pc_encoder\.patch_embed|mask_encoder)\.patch_encoder\.conv[12]\.[013]{_WB}",
    rf"pc_encoder\.(patch_proj|out_proj|pos_embed\.[02]){_WB}",
    rf"{_B}\.(norm[12]|attn\.(q_proj|k_proj|v_proj|proj|norm)|mlp\.(fc1_g|fc1_x|fc2|fc1|norm))"
    rf"{_WB}",
    rf"{_B}\.attn\.(qkv\.weight|q_bias|v_bias)",
    rf"pc_encoder\.transformer\.(norm|fc_norm){_WB}",
    r"point_encoder\.pe_layer\.positional_encoding_gaussian_matrix",
    r"point_encoder\.point_embeddings\.[01]\.weight",
    r"mask_encoder\.no_mask_embed\.weight",
    r"mask_decoder\.(iou_token|mask_tokens)\.weight",
    rf"{_L}\.(self_attn|cross_attn_token_to_image|cross_attn_image_to_token)\.{_ATTN}",
    rf"{_L}\.(norm[1-4]|mlp\.lin[12]){_WB}",
    rf"mask_decoder\.transformer\.final_attn_token_to_image\.{_ATTN}",
    rf"mask_decoder\.transformer\.norm_final_attn{_WB}",
    rf"mask_decoder\.output_upscaling\.[013]{_WB}",
    rf"mask_decoder\.(output_hypernetworks_mlps\.\d+|iou_prediction_head)\.layers\.\d+{_WB}",
)]
_FUSED_QKV = re.compile(rf"({_B}\.attn)\.(qkv\.weight|q_bias|v_bias)$")
_FC_NORM = "pc_encoder.transformer.fc_norm."


def classify_unmapped(key: str) -> str:
    """Triage a torch key with no destination in the model.

    Returns "recognized_unused" (a timm tensor the reference forward never
    runs: safe to drop, even strictly), "variant_unsupported" (a timm EVA
    variant tensor that would take part in the forward: dropping it would
    corrupt the numerics, so a strict load fails) or "unknown" (outside
    the documented key surface).
    """
    if any(p.match(key) for p in KNOWN_UNUSED):
        return "recognized_unused"
    if any(p.match(key) for p in KNOWN_VARIANT):
        return "variant_unsupported"
    return "unknown"


def load_reference_state_dict(model: torch.nn.Module, sd: dict, *, strict: bool = True) -> dict:
    """Load a reference-format state dict (torch key -> tensor or array)
    into ``model``'s parameters and buffers, each cast to its dtype and
    device.

    Returns the report of the JAX converter: ``mapped`` (model keys
    written), ``unmapped`` (keys outside the documented surface),
    ``recognized_unused`` and ``variant_unsupported`` (see
    ``classify_unmapped``; a surface key the model lacks is a variant too)
    and ``unfilled`` (model keys nothing wrote). A shape mismatch raises
    ValueError; ``strict`` also raises on ``variant_unsupported`` and
    ``unmapped`` keys. Nothing is written before every check has passed.
    """
    targets = model.state_dict(keep_vars=True)
    writes, split = [], {}
    unmapped, recognized, variant = [], [], []
    for key, value in sd.items():
        m = _FUSED_QKV.match(key)
        if m and key not in targets and f"{m.group(1)}.q_proj.weight" in targets:
            split.setdefault(m.group(1), {})[m.group(2)] = (key, value)
            continue
        dst = "pc_encoder.transformer.norm." + key[len(_FC_NORM):] \
            if key.startswith(_FC_NORM) else key
        if dst in targets:
            writes.append((dst, value, key))
        elif classify_unmapped(key) == "recognized_unused":
            recognized.append(key)
        elif classify_unmapped(key) == "variant_unsupported" or \
                any(p.match(key) for p in _SURFACE):
            variant.append(key)
        else:
            unmapped.append(key)
    # timm's fused projection onto separate q / k / v: F.linear(x, qkv.weight,
    # cat(q_bias, 0, v_bias)) is three products with the weight's thirds.
    for prefix, parts in split.items():
        if "qkv.weight" in parts:
            key, w = parts["qkv.weight"]
            w = torch.as_tensor(w)
            d = w.shape[0] // 3
            for i, name in enumerate(("q_proj", "k_proj", "v_proj")):
                writes.append((f"{prefix}.{name}.weight", w[i * d:(i + 1) * d], key))
        for bias, name in (("q_bias", "q_proj"), ("v_bias", "v_proj")):
            if bias in parts:
                key, b = parts[bias]
                writes.append((f"{prefix}.{name}.bias", b, key))
    for dst, value, key in writes:
        shape, want = tuple(np.shape(value)), tuple(targets[dst].shape)
        if shape != want:
            raise ValueError(f"shape mismatch for {key} -> {dst}: {shape} vs {want}")
    if strict and variant:
        raise ValueError(
            "checkpoint carries module-variant tensors this model was not "
            f"configured with: {sorted(variant)[:8]} ... If these are "
            "attn.norm.* (timm EvaAttention sub-LN), rebuild the model with "
            "ViTConfig(attn_inner_norm=True); q_norm/k_norm or layer-scale "
            "tensors would require the matching module additions. Loading "
            "non-strict would silently corrupt numerics.")
    if strict and unmapped:
        raise ValueError(f"unmapped torch keys: {sorted(unmapped)[:10]}...")
    with torch.no_grad():
        for dst, value, _ in writes:
            targets[dst].copy_(torch.as_tensor(value))
    filled = {dst for dst, _, _ in writes}
    return dict(mapped=len(filled), unmapped=sorted(unmapped),
                recognized_unused=sorted(recognized), variant_unsupported=sorted(variant),
                unfilled=sorted(set(targets) - filled))


# Uni3D's encoder prefixes and the port's (reference train.py:101-121).
UNI3D_SURGERY = (("point_encoder.encoder2trans.", "pc_encoder.patch_proj."),
                 ("point_encoder.pos_embed.", "pc_encoder.pos_embed."),
                 ("point_encoder.visual.", "pc_encoder.transformer."))


def convert_uni3d(sd: dict, model: torch.nn.Module) -> dict:
    """Uni3D pretrained-encoder initialisation (reference train.py:101-121):
    each key under a Uni3D prefix of ``UNI3D_SURGERY`` goes to the port's
    prefix beside it; every other key is left out. Loaded non-strict;
    returns the report."""
    module = sd.get("module", sd)
    remapped = {}
    for name, w in module.items():
        for src, dst in UNI3D_SURGERY:
            if name.startswith(src):
                remapped[dst + name[len(src):]] = w
                break
    return load_reference_state_dict(model, remapped, strict=False)


def load_torch_safetensors(path, model: torch.nn.Module, *, strict: bool = True) -> dict:
    """Load a reference ``.safetensors`` checkpoint into ``model`` (read by
    the port's own reader); returns the report."""
    from .safetensors_io import load_file

    return load_reference_state_dict(model, load_file(path), strict=strict)


# ------------------------------------------------------------ parity CLI
@torch.no_grad()
def golden_module_diffs(sd: dict, model: torch.nn.Module, decoder_heads: int = 8,
                        seed: int = 0) -> list:
    """Per-module activation diffs: the numpy oracles of ``utils/golden.py``
    on the RAW weights ``sd`` (numpy arrays) against ``model``'s modules on
    the weights loaded into it (an fp32 model: K2 and the ViT's attention
    kernel run where the model lives), on shared random inputs drawn as the
    JAX package draws them. Returns [(module name, max|diff| / max|oracle
    out|)]."""
    from . import golden

    dev = next(model.parameters()).device
    rng = np.random.default_rng(seed)
    out = []

    def rel(got, want):
        # Relative to the output scale: immune to the activation blow-up of
        # synthetic random-weight checkpoints.
        denom = max(float(np.abs(want).max()), 1e-6)
        return float(np.abs(got.float().cpu().numpy() - want).max()) / denom

    def put(x):
        return torch.from_numpy(x).to(dev)

    def pointnet_case(name, prefix, mod):
        keys = golden.sub(sd, prefix)
        if not keys or mod is None:
            return
        x = rng.standard_normal((2, 4, 8, keys["conv1.0.weight"].shape[1])).astype(np.float32)
        out.append((name, rel(mod(put(x)), golden.pointnet(keys, x))))

    pointnet_case("patch_embed.patch_encoder", "pc_encoder.patch_embed.patch_encoder",
                  getattr(model.pc_encoder.patch_embed, "patch_encoder", None))
    pointnet_case("mask_encoder.patch_encoder", "mask_encoder.patch_encoder",
                  getattr(model.mask_encoder, "patch_encoder", None))

    blocks = model.pc_encoder.transformer.blocks
    vit_cfg = model.cfg.vit_cfg
    for bi in sorted({0, vit_cfg.depth - 1}):
        bsd = golden.sub(sd, f"pc_encoder.transformer.blocks.{bi}")
        if not bsd:
            continue
        x = rng.standard_normal((1, 6, vit_cfg.embed_dim)).astype(np.float32)
        want = golden.eva_block(bsd, x, vit_cfg.num_heads)
        out.append((f"vit.block_{bi}", rel(blocks[bi](put(x)), want)))

    twsd = golden.sub(sd, "mask_decoder.transformer")
    if twsd:
        dim = twsd["norm_final_attn.weight"].shape[0]
        pc, pe, tok = (rng.standard_normal(s).astype(np.float32)
                       for s in ((2, 10, dim), (2, 10, dim), (2, 5, dim)))
        wq, wk = golden.two_way_transformer(twsd, pc, pe, tok, heads=decoder_heads)
        gq, gk = model.mask_decoder.transformer(put(pc), put(pe), put(tok))
        out.append(("mask_decoder.transformer.queries", rel(gq, wq)))
        out.append(("mask_decoder.transformer.keys", rel(gk, wk)))
    return out


def checkpoint_check(path, config: str = "large", overrides=(), golden: bool = False,
                     device=None) -> dict:
    """Load the reference ``.safetensors`` file ``path`` into the fp32
    model of ``config`` on ``device`` (``cuda`` unless given) and print how
    every torch key fared (mapped / known-unused / variant / unknown) and
    which of the model's keys stayed unfilled; with ``golden``, also each
    module's activation diff against the numpy oracles
    (``golden_module_diffs``), each to be under 1e-4. Returns the result
    (``ok`` is False on any unmapped, unfilled or variant key or a golden
    diff at or above 1e-4)."""
    from ..ops._cuda import resolve_device
    from .config import build_model, load_config
    from .safetensors_io import load_file

    dev = resolve_device(device)
    cfg = load_config(config, list(overrides))
    model = build_model(cfg.model, dtype=torch.float32, device=dev,
                        generator=torch.Generator(dev).manual_seed(0))
    sd = load_file(path)
    report = load_reference_state_dict(model, sd, strict=False)
    n_mapped = len(sd) - sum(map(len, (report["unmapped"], report["recognized_unused"],
                                       report["variant_unsupported"])))
    print(f"checkpoint: {path}  ({len(sd)} torch keys)  config: {config}  device: {dev}")
    print(f"  mapped                {n_mapped}")
    print(f"  recognized_unused     {len(report['recognized_unused'])}"
          "  (timm tensors the reference forward never runs)")
    print(f"  variant_unsupported   {len(report['variant_unsupported'])}")
    for k in report["variant_unsupported"][:8]:
        print(f"    !! {k}")
    print(f"  unknown unmapped      {len(report['unmapped'])}")
    for k in report["unmapped"][:8]:
        print(f"    ?? {k}")
    print(f"  our params unfilled   {len(report['unfilled'])}")
    for k in report["unfilled"][:8]:
        print(f"    .. {k}")
    ok = not (report["unmapped"] or report["unfilled"] or report["variant_unsupported"])
    result = {"keys": len(sd), "mapped": n_mapped, "ok": ok,
              "unmapped": report["unmapped"], "unfilled": report["unfilled"],
              "variant_unsupported": report["variant_unsupported"]}
    if golden:
        raw = {k: (v.float() if v.is_floating_point() else v).numpy() for k, v in sd.items()}
        model.eval()
        diffs = golden_module_diffs(raw, model, decoder_heads=cfg.model["decoder"]["num_heads"])
        print("golden activation diffs (numpy oracle on raw torch weights vs the "
              "port's fp32 module; max|diff| / max|oracle out|):")
        for name, d in diffs:
            print(f"  {name:40s} rel diff = {d:.2e}{'' if d < 1e-4 else '  <-- LARGE'}")
        result["golden"] = dict(diffs)
        result["golden_ok"] = all(d < 1e-4 for _, d in diffs)
        result["ok"] = ok = ok and result["golden_ok"]
    print("PARITY OK" if ok else "PARITY ISSUES FOUND (see above)")
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="point_sam_tpu_torch.utils.convert",
        description="Reference-checkpoint triage and parity check")
    parser.add_argument("--check", required=True, metavar="SAFETENSORS",
                        help="path to a reference-format .safetensors")
    parser.add_argument("--config", default="large")
    parser.add_argument("--golden", action="store_true",
                        help="also diff per-module activations against numpy oracles "
                        "of the reference semantics")
    parser.add_argument("--device", default=None, help="torch device (default: cuda)")
    parser.add_argument("overrides", nargs="*", default=[])
    args = parser.parse_args(argv)
    result = checkpoint_check(args.check, args.config, args.overrides, golden=args.golden,
                              device=args.device)
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
