"""Debug-image plotting (reference utils/plot_utils.py + semivl.py:371-406).

Renders a grid of images / predictions / pseudo-labels per sampled batch
element into the run dir. matplotlib is optional. A copy of
``semivl_tpu/utils/plotting.py``."""

import os

import numpy as np

from semivl_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD


def denormalize_image(img):
    """float HWC ImageNet-normalised -> uint8 HWC."""
    arr = np.asarray(img) * IMAGENET_STD + IMAGENET_MEAN
    return (np.clip(arr, 0, 1) * 255).astype(np.uint8)


def colorize_label(label, palette):
    """int (H, W) -> uint8 (H, W, 3) using a (256, 3) palette."""
    label = np.asarray(label).astype(np.int32)
    pal = np.asarray(palette)
    if pal.shape[0] < 256:
        pal = np.concatenate(
            [pal, np.zeros((256 - pal.shape[0], 3), np.uint8)])
    return pal[np.clip(label, 0, 255)]


def plot_data(ax, title, data, kind, palette=None):
    ax.set_title(title, fontsize=6)
    ax.axis('off')
    if kind == 'image':
        ax.imshow(denormalize_image(data))
    elif kind == 'prediction':
        ax.imshow(colorize_label(np.argmax(np.asarray(data), axis=0),
                                 palette))
    elif kind == 'label':
        ax.imshow(colorize_label(data, palette))
    else:
        raise ValueError(kind)


def save_debug_grid(path, plot_dicts, rows, cols):
    """plot_dicts: list of (title, data, kind, palette) or None entries."""
    try:
        import matplotlib
        matplotlib.use('Agg')
        from matplotlib import pyplot as plt
    except Exception:
        return False
    fig, axs = plt.subplots(
        rows, cols, figsize=(2 * cols, 2 * rows), squeeze=False,
        gridspec_kw={'hspace': 0.1, 'wspace': 0, 'top': 0.95, 'bottom': 0,
                     'right': 1, 'left': 0})
    for ax, pd in zip(axs.flat, plot_dicts):
        if pd is not None:
            plot_data(ax, *pd)
        else:
            ax.axis('off')
    os.makedirs(os.path.dirname(path), exist_ok=True)
    plt.savefig(path)
    plt.close(fig)
    return True
