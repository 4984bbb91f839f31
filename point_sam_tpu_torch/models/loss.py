"""Training criterion (counterpart of point_sam_tpu/models/loss.py): focal +
2 * dice mask loss and the IoU-prediction MSE.

On the first click iteration the multimask output with the lowest mask
loss supervises (SAM's ambiguity-aware rule); later iterations have one
mask. The total is the mean over iterations of (mask loss + IoU MSE). The
IoU target is detached, as in the reference.
"""

from __future__ import annotations

import torch


def sigmoid_focal_loss(logits, targets, alpha: float = -1.0, gamma: float = 2.0):
    """Elementwise focal loss on logits (alpha < 0: no class weighting)."""
    p = torch.sigmoid(logits)
    # Numerically stable binary cross-entropy with logits.
    ce = logits.clamp_min(0.0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))
    p_t = p * targets + (1.0 - p) * (1.0 - targets)
    loss = ce * (1.0 - p_t) ** gamma
    if alpha >= 0:
        loss = (alpha * targets + (1.0 - alpha) * (1.0 - targets)) * loss
    return loss


def dice_loss(probs, targets, eps: float = 1e-3):
    """Soft dice over the last axis."""
    numerator = 2.0 * (probs * targets).sum(-1)
    denominator = probs.square().sum(-1) + targets.sum(-1)
    return 1.0 - (numerator + eps) / (denominator + eps)


def compute_mask_loss(logits, labels, loss_weight_dice: float = 2.0):
    """[B, C, N] logits vs [B, N] binary labels -> [B, C] per-mask loss."""
    labels_f = labels[:, None, :].to(logits.dtype).expand_as(logits)
    loss_ce = sigmoid_focal_loss(logits, labels_f)
    loss_dice = dice_loss(torch.sigmoid(logits), labels_f)
    return loss_ce.mean(-1) + loss_weight_dice * loss_dice


def compute_iou(logits, targets, threshold: float | None = None):
    """Hard IoU of thresholded predictions over the last axis."""
    preds = logits > 0 if threshold is None else torch.sigmoid(logits) > threshold
    inter = (preds & targets).sum(-1)
    union = (preds | targets).sum(-1)
    return inter / union.clamp_min(1)


def compute_jaccard(logits, targets, eps: float = 1e-3):
    probs = torch.sigmoid(logits)
    t = targets.to(probs.dtype)
    numerator = (probs * t).sum(-1)
    denominator = (probs.square() + t.square()).sum(-1) - numerator
    return (numerator + eps) / (denominator + eps)


def criterion(outputs: list[dict], gt_masks: torch.Tensor, use_soft_iou: bool = False):
    """Args:
        outputs: per-iteration dicts of ``PointCloudSAM.forward`` with
            masks [B*M, C, N] and iou_preds [B*M, C].
        gt_masks: [B*M, N] bool.

    Returns:
        (scalar loss, per-iteration aux dicts {iou, best_masks, loss_mask,
        loss_iou}).
    """
    losses, aux_outputs = [], []
    for i, output in enumerate(outputs):
        masks = output["masks"].float()
        iou_preds = output["iou_preds"].float()
        loss_mask = compute_mask_loss(masks, gt_masks)  # [B*M, C]
        if i == 0:
            min_idx = loss_mask.argmin(1)
            loss_mask = loss_mask.amin(1)
            best_masks = torch.take_along_dim(masks, min_idx[:, None, None], dim=1)[:, 0]
            iou_preds = torch.take_along_dim(iou_preds, min_idx[:, None], dim=1)[:, 0]
        else:
            best_masks = masks[:, 0]
            iou_preds = iou_preds[:, 0]
        loss_mask = loss_mask.mean()
        iou = compute_iou(best_masks, gt_masks)
        target = compute_jaccard(best_masks, gt_masks) if use_soft_iou else iou.float()
        loss_iou = (target.detach() - iou_preds).square().mean()
        losses.append(loss_iou + loss_mask)
        aux_outputs.append(dict(iou=iou, best_masks=best_masks, loss_mask=loss_mask,
                                loss_iou=loss_iou))
    return torch.stack(losses).mean(), aux_outputs
