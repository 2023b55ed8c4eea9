"""Segmentation metrics (counterpart of ``semivl_tpu/evaluation/metrics.py``).

Per-class intersection/union histograms with ignore-index masking and
mIoU = mean(I / U) (reference third_party/unimatch/util/utils.py:91-103).
"""

import numpy as np


def intersection_and_union(output, target, num_classes, ignore_index=255):
    """``output``/``target``: int arrays of one shape. Returns
    (area_intersection, area_union, area_target), each (K,) int64."""
    output = np.asarray(output).reshape(-1).copy()
    target = np.asarray(target).reshape(-1)
    assert output.shape == target.shape, (output.shape, target.shape)
    output[target == ignore_index] = ignore_index
    intersection = output[output == target]
    bins = np.arange(num_classes + 1)
    area_intersection, _ = np.histogram(intersection, bins=bins)
    area_output, _ = np.histogram(output, bins=bins)
    area_target, _ = np.histogram(target, bins=bins)
    area_union = area_output + area_target - area_intersection
    return area_intersection, area_union, area_target


def miou_from_histograms(intersection_sum, union_sum):
    iou_class = intersection_sum / (union_sum + 1e-10) * 100.0
    return float(np.mean(iou_class)), iou_class
