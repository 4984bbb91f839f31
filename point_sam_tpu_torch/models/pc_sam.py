"""PointCloudSAM, the promptable segmentation model (counterpart of
point_sam_tpu/models/pc_sam.py): the point-cloud ViT encoder, the click
and mask prompt encoders and the mask decoder, with the encode-once /
decode-per-click API and the training ``forward``: encode once, then
``prompt_iters`` simulated-click iterations, each carrying the chosen mask
logits forward as the next iteration's mask prompt.

The click loop keeps the JAX loop's shape: one prompt slot per iteration;
with mask-refinement iterations on (training), the last iteration and one
iteration drawn from ``randint(1, prompt_iters)`` add no click (the drawn
one skips the sampler), and iteration 0 always clicks. The flagship and
voronoi models click by the fixed sampler (farthest from the region's
border); the hier model by the random one (a uniform point of the error
region), whose noise is drawn on the coordinates' device.
"""

from __future__ import annotations

import copy
import dataclasses

import torch
from torch import nn

from ..ops.sampler import sample_prompts, sample_prompts_random
from .layers import Dense
from .mask_decoder import MaskDecoder
from .pc_encoder import PointCloudEncoder
from .prompt_encoder import MaskEncoder, PointEncoder, mask_group_rel_xyz
from .tokenizer import TokenizerConfig, compute_geometry
from .vit import ViTConfig, get_vit_config


@dataclasses.dataclass(frozen=True)
class PointSAMConfig:
    """Model hyperparameters (reference configs/model/default.yaml)."""

    vit: str | ViTConfig = "eva02_large"
    tokenizer: TokenizerConfig = TokenizerConfig(num_patches=1024, patch_size=256)
    embed_dim: int = 256
    patch_embed_channels: int = 512
    num_multimask_outputs: int = 3
    decoder_depth: int = 2
    decoder_num_heads: int = 8
    decoder_mlp_dim: int = 2048
    prompt_iters: int = 5
    enable_mask_refinement_iterations: bool = True
    # "erf" = torch nn.GELU default (reference parity); "tanh" = the tanh
    # approximation. The parameters are the same either way.
    patch_act: str = "erf"

    @property
    def vit_cfg(self) -> ViTConfig:
        return get_vit_config(self.vit) if isinstance(self.vit, str) else self.vit


def for_inference(model):
    """The JAX package turns off ViT remat here; the port's remat acts only
    while a gradient is recorded, so this is the identity (kept so callers
    read the same in both packages)."""
    return model


def for_sharded_eval(model, group):
    """A copy of ``model`` whose decoder splits its N-point tail over the
    ranks of ``group`` (``MaskDecoder.point_group``: each rank decodes its
    shard of the points, an all-gather returns the whole logits). Every
    parameter and buffer is ``model``'s own, not a copy; ``model`` itself
    is unchanged. The big-scene evaluator uses it together with the
    point-sharded kNN (``parallel.sharded_geometry``)."""
    if not isinstance(getattr(model, "mask_decoder", None), MaskDecoder):
        raise TypeError(f"{type(model).__name__} has no MaskDecoder to shard")
    if model.mask_decoder.point_group is group:
        return model
    decoder = copy.copy(model.mask_decoder)
    decoder.point_group = group
    out = copy.copy(model)
    out._modules = {**model._modules, "mask_decoder": decoder}
    return out


@torch.no_grad()
def cast_params_for_inference(model: nn.Module, dtype: torch.dtype | None = None):
    """Pre-cast every Dense weight to the compute dtype, in place.

    Each Dense casts its weight to its ``dtype`` on every call anyway, so
    this is bit-identical and saves the per-call convert. Biases, LayerNorm
    parameters, embeddings and the PE buffer keep fp32. Returns ``model``.
    """
    for m in model.modules():
        if isinstance(m, Dense):
            m.weight.data = m.weight.data.to(dtype or m.dtype)
    return model


class PointCloudSAM(nn.Module):
    # The simulated clicks' sampler (``_click_loop``).
    click_sampler = "fixed"

    def __init__(self, cfg: PointSAMConfig, *, dtype=torch.float32, in_channels: int = 3,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.pc_encoder = PointCloudEncoder(
            cfg.vit_cfg, cfg.tokenizer, in_channels=in_channels, embed_dim=cfg.embed_dim,
            patch_embed_channels=cfg.patch_embed_channels, act=cfg.patch_act, **kw)
        self.point_encoder = PointEncoder(cfg.embed_dim, **kw)
        self.mask_encoder = MaskEncoder(cfg.embed_dim, act=cfg.patch_act, **kw)
        self.mask_decoder = MaskDecoder(
            cfg.embed_dim, cfg.num_multimask_outputs, depth=cfg.decoder_depth,
            num_heads=cfg.decoder_num_heads, mlp_dim=cfg.decoder_mlp_dim, **kw)

    @property
    def default_grouping(self) -> tuple[int, int]:
        """(G centres, K neighbours per centre) of the model's tokenizer."""
        return self.cfg.tokenizer.num_patches, self.cfg.tokenizer.patch_size

    def make_geometry(self, coords, *, point_valid=None, tokenizer=None, group_number=None,
                      group_size=None) -> dict:
        """Parameter-free tokenizer geometry. Evaluation may pass a whole
        ``TokenizerConfig`` per scene, serving may override G and K."""
        tok = tokenizer or self.cfg.tokenizer
        tok = dataclasses.replace(tok, num_patches=group_number or tok.num_patches,
                                  patch_size=group_size or tok.patch_size)
        return compute_geometry(coords, tok, point_valid=point_valid)

    def prompt_cache(self, coords, geom) -> dict:
        """The click-invariant half of the mask-prompt features, cached in
        ``geom`` once per cloud: each centre's neighbour offsets."""
        return dict(mask_rel_xyz=mask_group_rel_xyz(coords, geom["centers"], geom["knn_idx"],
                                                    radius=self.mask_encoder.radius))

    def encode(self, coords, features, geom):
        """Returns (pc_embeddings [B, G, D], pc_pe [B, G, D])."""
        emb = self.pc_encoder.patch_embed(coords, features, geom)
        pc_embeddings = self.pc_encoder(emb, geom["centers"])
        pc_pe = self.point_encoder.pe_layer(geom["centers"])
        return pc_embeddings, pc_pe

    def decode(self, pc_embeddings, pc_pe, coords, geom, prompt_coords, prompt_labels,
               prompt_masks=None, *, prompt_valid=None, multimask_output=True):
        """One decoder pass against cached embeddings.

        Args:
            prompt_coords [B*M, P, 3]; prompt_labels [B*M, P];
            prompt_masks: optional [B*M, N] logits; prompt_valid [B*M, P].

        Returns:
            (masks [B*M, C, N] fp32 logits, iou_pred [B*M, C] fp32).
        """
        sparse = self.point_encoder(prompt_coords, prompt_labels)
        dense = self.mask_encoder(prompt_masks, coords, geom["centers"], geom["knn_idx"],
                                  rel_xyz=geom.get("mask_rel_xyz"))
        return self.mask_decoder(
            pc_embeddings, pc_pe, sparse, dense,
            interp_index=geom["interp_index"], interp_weight=geom["interp_weight"],
            prompt_valid=prompt_valid, multimask_output=multimask_output)

    def predict_masks(self, coords, features, prompt_coords, prompt_labels,
                      prompt_masks=None, *, prompt_valid=None, point_valid=None,
                      multimask_output=True):
        """Encode + one decode (reference pc_sam.py:37-88)."""
        geom = self.make_geometry(coords, point_valid=point_valid)
        pc_embeddings, pc_pe = self.encode(coords, features, geom)
        return self.decode(pc_embeddings, pc_pe, coords, geom, prompt_coords,
                           prompt_labels, prompt_masks, prompt_valid=prompt_valid,
                           multimask_output=multimask_output)

    def forward(self, coords, features, gt_masks, *, is_eval: bool = False,
                point_valid=None, generator: torch.Generator | None = None,
                rows: tuple[int, int] | None = None):
        """Training / evaluation forward with simulated clicks.

        Args:
            coords: [B, N, 3] unit-sphere coordinates. features: [B, N, C].
            gt_masks: [B, M, N] bool.
            is_eval: no refinement-only iterations (every iteration clicks).
            generator: draws the refinement iteration; needed when
                refinement iterations are on and prompt_iters > 1.
            rows: (start, total): the batch is rows [start, start + B) of
                one of ``total`` clouds (the random sampler's noise is
                drawn for all of them); None: the whole batch.

        Returns:
            ``prompt_iters`` dicts with prompt_coords, prompt_labels,
            prompt_valid, masks [B*M, C, N], iou_preds [B*M, C],
            max_iou_pred_ind and prompt_masks [B*M, N].
        """
        geom = self.make_geometry(coords, point_valid=point_valid)
        pc_embeddings, pc_pe = self.encode(coords, features, geom)
        # Geometry only: the mask prompt's neighbour offsets, once for all
        # iterations.
        geom.update(self.prompt_cache(coords, geom))
        return _click_loop(self, pc_embeddings, pc_pe, coords, geom, gt_masks,
                           is_eval=is_eval, point_valid=point_valid, generator=generator,
                           sampler=self.click_sampler, rows=rows)


def click_draws(cfg, generator: torch.Generator | None, *, is_eval: bool = False,
                sampler: str = "fixed") -> tuple[int, int | None]:
    """The draws one simulated-click forward takes from ``generator``, in
    its order: the refinement-only iteration (-1 when there is none) and,
    for the random sampler, the seed of its noise (else None). A
    data-parallel step replays them to find the generator state at which
    each micro-batch of the global batch starts (``parallel.train_step``)."""
    sampled_refine, seed = -1, None
    iters = cfg.prompt_iters
    if cfg.enable_mask_refinement_iterations and not is_eval and iters > 1:
        if generator is None:
            raise ValueError("refinement iterations need a torch.Generator")
        sampled_refine = int(torch.randint(1, iters, (1,), generator=generator,
                                           device=generator.device))
    if sampler == "random":
        if generator is None:
            raise ValueError("the random click sampler needs a torch.Generator")
        seed = int(torch.randint(2 ** 62, (1,), generator=generator, device=generator.device))
    return sampled_refine, seed


def _click_loop(model, pc_embeddings, pc_pe, coords, geom, gt_masks, *, is_eval,
                point_valid, generator, sampler="fixed", decode_extra=None, rows=None):
    """The prompt-iteration loop (JAX ``_click_loop``).

    ``sampler``: "fixed" (``sample_prompts``) or "random"
    (``sample_prompts_random``). The random sampler's noise is drawn on the
    coordinates' device from a generator that ``generator`` seeds once a
    call (after the refinement draw); each iteration reseeds it with that
    seed plus its index, so no iteration's clicks depend on which one
    skipped the sampler (JAX draws a key every iteration for the same
    reason). ``decode_extra``: keyword arguments every decode also takes
    (the hier model's ``embeddings_l1``). ``rows``: as ``forward``'s."""
    c = model.cfg
    B, M, N = gt_masks.shape
    BM, iters, dev = B * M, c.prompt_iters, coords.device
    buf_coords = torch.zeros((BM, iters, 3), dtype=coords.dtype, device=dev)
    buf_labels = torch.zeros((BM, iters), dtype=torch.bool, device=dev)
    buf_valid = torch.zeros((BM, iters), dtype=torch.bool, device=dev)

    refinement = c.enable_mask_refinement_iterations and not is_eval
    sampled_refine, seed = click_draws(c, generator, is_eval=is_eval, sampler=sampler)
    if sampler == "random":
        noise = torch.Generator(dev)

    prompt_masks = None
    outputs = []
    for i in range(iters):
        statically_refine = refinement and i == iters - 1 and i != 0
        if not statically_refine and (i == 0 or i != sampled_refine):
            if sampler == "random":
                new_pc, new_pl = sample_prompts_random(noise.manual_seed(seed + i), coords,
                                                       gt_masks, prompt_masks,
                                                       point_valid=point_valid,
                                                       **({} if rows is None else {"rows": rows}))
            else:
                new_pc, new_pl = sample_prompts(coords, gt_masks, prompt_masks,
                                                point_valid=point_valid)
            buf_coords[:, i] = new_pc[:, 0]
            buf_labels[:, i] = new_pl[:, 0]
            buf_valid[:, i] = True
        masks, iou_preds = model.decode(
            pc_embeddings, pc_pe, coords, geom, prompt_coords=buf_coords[:, :i + 1],
            prompt_labels=buf_labels[:, :i + 1], prompt_masks=prompt_masks,
            prompt_valid=buf_valid[:, :i + 1], multimask_output=(i == 0), **(decode_extra or {}))
        if i == 0:
            max_iou_pred_ind = iou_preds.argmax(1)
            prompt_masks = torch.take_along_dim(masks, max_iou_pred_ind[:, None, None],
                                                dim=1)[:, 0]
        else:
            max_iou_pred_ind = torch.zeros((BM,), dtype=torch.long, device=dev)
            prompt_masks = masks[:, 0]
        outputs.append(dict(
            prompt_coords=buf_coords[:, :i + 1].clone(),
            prompt_labels=buf_labels[:, :i + 1].clone(),
            prompt_valid=buf_valid[:, :i + 1].clone(),
            masks=masks, iou_preds=iou_preds, max_iou_pred_ind=max_iou_pred_ind,
            prompt_masks=prompt_masks))
    return outputs
