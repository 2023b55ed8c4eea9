from semivl_tpu_torch.native.loader import (
    decode_image,
    native_available,
    normalize_imagenet,
    resize_bilinear,
    resize_nearest,
)

__all__ = [
    "decode_image",
    "native_available",
    "normalize_imagenet",
    "resize_bilinear",
    "resize_nearest",
]
