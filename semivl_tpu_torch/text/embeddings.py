"""CLIP text-embedding assets (counterpart of
``semivl_tpu/text/embeddings.py``).

Embeddings are precomputed with CLIP ViT-B/16's text encoder over
``"a photo of a {c}"`` prompts and L2-normalised (reference
model/text_embeddings.py:156-186); the ``.npy`` assets are float16 of shape
(num_classes_or_concepts, 512). This package carries only the asset its
flagship needs (``voc12_wbg_single``, one row per VOC class).
"""

import os

import numpy as np

_ASSET_DIR = os.path.join(
    os.path.dirname(os.path.dirname(__file__)), 'assets', 'text_embedding')

# Dataset key -> embedding asset prefix (reference model/builder.py:119-124).
EMB_DATASET_PREFIX = {'pascal': 'voc12_wbg'}


def text_embedding_path(dataset, variant):
    """Path of the bundled text-embedding asset for (dataset, variant)."""
    return os.path.join(_ASSET_DIR,
                        f'{EMB_DATASET_PREFIX[dataset]}_{variant}.npy')


def load_text_embedding(path):
    """(N, 512) float32 L2-normalised text embedding from an asset path."""
    return np.load(path).astype(np.float32)
