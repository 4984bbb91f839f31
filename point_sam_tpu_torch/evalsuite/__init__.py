"""Evaluation entry points of the PyTorch port: the interactive evaluator
(mean IoU per click), one-shot inference and the KITTI-360 crop converter."""
