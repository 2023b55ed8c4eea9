"""CLIP text-embedding assets (counterpart of
``semivl_tpu/text/embeddings.py``).

Embeddings are precomputed with CLIP ViT-B/16's text encoder over
``"a photo of a {c}"`` prompts and L2-normalised (reference
model/text_embeddings.py:156-186); the ``.npy`` assets are float16 of shape
(num_classes_or_concepts, 512). This package carries every asset of the
JAX package, byte for byte: for VOC ``voc12_wbg_single`` (one row per VOC
class, the flagship decoder's text), ``voc12_wbg_concept4_single`` (98
concepts of the 21 classes, the guidance labels' text, and a decoder text
that the heads aggregate back to classes by a max) and
``voc12_wbg_conceptavg4_single`` (21 rows, each the mean of a class's
concepts); for Cityscapes ``cityscapes_conceptavg3_single`` (19 rows: exp
44's decoder text), ``cityscapes_concept3_single`` (54 concepts, the
guidance labels' text) and ``cityscapes_single`` (19 rows, the generator's
default variant); for COCO exp 42 ``coco_single`` (81 rows) and for ADE20K
exp 43 ``ade_single`` (150 rows), each the decoder's and the guidance
labels' text.
"""

import os

import numpy as np
import torch

from semivl_tpu_torch.ops.resize import device_constant
from semivl_tpu_torch.text import concepts as _concepts

_ASSET_DIR = os.path.join(
    os.path.dirname(os.path.dirname(__file__)), 'assets', 'text_embedding')

# Dataset key -> embedding asset prefix (reference model/builder.py:119-124).
EMB_DATASET_PREFIX = {'pascal': 'voc12_wbg', 'cityscapes': 'cityscapes',
                      'coco': 'coco', 'ade': 'ade'}


def text_embedding_path(dataset, variant):
    """Path of the bundled text-embedding asset for (dataset, variant). An
    absolute ``.npy`` path passes through unchanged (custom guidance text,
    e.g. ``tools/semi_effect_demo.py``'s synthetic CLIP text)."""
    if os.path.isabs(str(variant)):
        return variant
    return os.path.join(_ASSET_DIR,
                        f'{EMB_DATASET_PREFIX[dataset]}_{variant}.npy')


def load_text_embedding(path):
    """(N, 512) float32 L2-normalised text embedding from an asset path."""
    return np.load(path).astype(np.float32)


def get_class_to_concept_idxs(path_or_name):
    """Class index -> list of concept row indices of a concept embedding,
    keyed by the asset's base name (reference
    model/text_embeddings.py:208-215)."""
    name = os.path.basename(str(path_or_name))
    if name.endswith('.npy'):
        name = name[:-len('.npy')]
    if name not in _concepts.CONCEPT_LISTS:
        raise ValueError(f'No concept list known for embedding {name!r}')
    return _concepts.flatten_class_concepts(
        _concepts.CONCEPT_LISTS[name])[2]


def concept_aggregation_matrix(class_to_concept_idxs, num_concepts):
    """(num_classes, num_concepts) bool matrix: M[c, k] = concept k in
    class c."""
    mat = np.zeros((len(class_to_concept_idxs), num_concepts), dtype=bool)
    for cls_i, conc_idxs in class_to_concept_idxs.items():
        mat[cls_i, conc_idxs] = True
    return mat


def aggregate_concept_predictions(pred, class_to_concept_idxs):
    """Max-aggregate (B, num_concepts, H, W) concept logits to
    (B, num_classes, H, W) class logits (reference
    model/text_embeddings.py:188-193), as a masked max over the membership
    matrix (uploaded once per device, ``device_constant``)."""
    key = ('concepts', pred.shape[1], tuple(
        (c, tuple(v)) for c, v in sorted(class_to_concept_idxs.items())))
    mask = device_constant(key, lambda: concept_aggregation_matrix(
        class_to_concept_idxs, pred.shape[1]), pred.device, torch.bool)
    masked = torch.where(mask[None, :, :, None, None], pred[:, None],
                         pred.new_full((), float('-inf')))
    return masked.amax(dim=2)
