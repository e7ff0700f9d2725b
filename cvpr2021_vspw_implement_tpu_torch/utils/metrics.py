"""Segmentation and video-consistency metrics (copies of the JAX package's
utils/metrics.py: ``Evaluator`` and ``get_common`` in numpy, reference
utils.py:37-107; ``pixel_acc`` on tensors).

Labels >= num_class (255 after remap) are ignored; mIoU averages over the
classes present in the ground truth; VC over a window of ``clip_num`` frames
is the share of pixels whose prediction agrees across the window among those
whose ground truth does.
"""

from __future__ import annotations

import numpy as np
import torch


def confusion_matrix_np(gt, pred, num_class: int) -> np.ndarray:
    """Confusion-matrix increment (reference: utils.py:91-100)."""
    gt = np.asarray(gt)
    pred = np.asarray(pred)
    mask = (gt >= 0) & (gt < num_class)
    label = num_class * gt[mask].astype(np.int64) + pred[mask].astype(np.int64)
    count = np.bincount(label, minlength=num_class ** 2)
    return count.reshape(num_class, num_class)


class Evaluator:
    """Confusion-matrix metrics (reference: utils.py:55-107)."""

    def __init__(self, num_class: int):
        self.num_class = num_class
        self.confusion_matrix = np.zeros((num_class, num_class), np.float64)

    def add_batch(self, gt_image, pre_image):
        if np.shape(gt_image) != np.shape(pre_image):
            raise ValueError(f"shape mismatch {np.shape(gt_image)} vs "
                             f"{np.shape(pre_image)}")
        self.confusion_matrix += confusion_matrix_np(gt_image, pre_image,
                                                     self.num_class)

    def Pixel_Accuracy(self):
        return np.diag(self.confusion_matrix).sum() / self.confusion_matrix.sum()

    def Pixel_Accuracy_Class(self):
        with np.errstate(divide="ignore", invalid="ignore"):
            acc = np.diag(self.confusion_matrix) / self.confusion_matrix.sum(axis=1)
        return np.nanmean(acc)

    def Mean_Intersection_over_Union(self):
        with np.errstate(divide="ignore", invalid="ignore"):
            iou = np.diag(self.confusion_matrix) / (
                np.sum(self.confusion_matrix, axis=1)
                + np.sum(self.confusion_matrix, axis=0)
                - np.diag(self.confusion_matrix))
        isval = np.sum(self.confusion_matrix, axis=1) > 0
        return np.nansum(iou * isval) / isval.sum()

    def Frequency_Weighted_Intersection_over_Union(self):
        freq = np.sum(self.confusion_matrix, axis=1) / np.sum(self.confusion_matrix)
        with np.errstate(divide="ignore", invalid="ignore"):
            iu = np.diag(self.confusion_matrix) / (
                np.sum(self.confusion_matrix, axis=1)
                + np.sum(self.confusion_matrix, axis=0)
                - np.diag(self.confusion_matrix))
        return (freq[freq > 0] * iu[freq > 0]).sum()


def get_common(gt_list, pred_list, clip_num: int, h: int, w: int):
    """Sliding-window VC accuracies (reference: utils.py:37-53); windows
    whose ground truth never agrees give nan."""
    accs = []
    for i in range(len(gt_list) - clip_num):
        gt_common = np.ones((h, w), dtype=bool)
        pred_common = np.ones((h, w), dtype=bool)
        for j in range(1, clip_num):
            gt_common &= (gt_list[i] == gt_list[i + j])
            pred_common &= (pred_list[i] == pred_list[i + j])
        agree = pred_common & gt_common
        denom = gt_common.sum()
        accs.append(agree.sum() / denom if denom else np.nan)
    return accs


def pixel_acc(pred_logits: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """Training pixel accuracy (reference: models/models.py:65-71):
    pred_logits [N, C, H, W] (any monotone score), label [N, H, W] with
    negative = ignore."""
    preds = torch.argmax(pred_logits, dim=1)
    valid = label >= 0
    acc_sum = (valid & (preds == label)).sum()
    return acc_sum.float() / (valid.sum().float() + 1e-10)
