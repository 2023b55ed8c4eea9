"""ctypes bindings for the native image core, with transparent PIL fallback
(the counterpart of ``semivl_tpu/native/loader.py``).

Exposes decode (JPEG/PNG), PIL-parity bilinear/nearest resampling and fused
ImageNet normalisation. ``native_available()`` gates use; the host data
pipeline falls back to PIL when the .so can't be built. This is host
decode, not a device kernel.
"""

import ctypes

import numpy as np

_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    try:
        from semivl_tpu_torch.native.build import build
        path = build()
        lib = ctypes.CDLL(path)
        lib.decode_jpeg.restype = ctypes.c_int
        lib.decode_png.restype = ctypes.c_int
        _lib = lib
    except Exception:
        _lib = None
    return _lib


def native_available():
    return _load() is not None


def decode_image(data, channels=3, scale_denom=1):
    """Decode JPEG/PNG bytes -> HWC uint8 (channels=1 keeps mask indices).

    ``scale_denom`` in {1, 2, 4, 8}: JPEG IDCT-scaled decode — the output is
    ceil(dim/denom) at a fraction of the decode cost (ignored for PNG).
    """
    lib = _load()
    assert lib is not None, 'native image core unavailable'
    buf = np.frombuffer(data, np.uint8)
    out = ctypes.POINTER(ctypes.c_uint8)()
    w = ctypes.c_int()
    h = ctypes.c_int()
    src = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    if data[:2] == b'\xff\xd8':  # JPEG magic
        assert channels == 3
        rc = lib.decode_jpeg_scaled(src, len(data), scale_denom,
                                    ctypes.byref(out), 0,
                                    ctypes.byref(w), ctypes.byref(h))
    elif data[:4] == b'\x89PNG':
        rc = lib.decode_png(src, len(data), channels, ctypes.byref(out), 0,
                            ctypes.byref(w), ctypes.byref(h))
    else:
        raise ValueError('unknown image format')
    if rc != 0:
        raise ValueError(f'decode failed (rc={rc})')
    n = h.value * w.value * channels
    arr = np.ctypeslib.as_array(out, shape=(n,)).copy()
    lib.free_buffer(out)
    shape = (h.value, w.value, channels) if channels > 1 \
        else (h.value, w.value)
    return arr.reshape(shape)


def _resize(fn, img, oh, ow):
    img = np.ascontiguousarray(img, np.uint8)
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    h, w, c = img.shape
    dst = np.empty((oh, ow, c), np.uint8)
    fn(img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w, c,
       dst.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), oh, ow)
    return dst[..., 0] if squeeze else dst


def resize_bilinear(img, oh, ow):
    """PIL Image.BILINEAR-parity resize of HWC/HW uint8."""
    lib = _load()
    return _resize(lib.resize_bilinear_u8, img, oh, ow)


def resize_nearest(img, oh, ow):
    lib = _load()
    return _resize(lib.resize_nearest_u8, img, oh, ow)


def normalize_imagenet(img):
    """HWC uint8 RGB -> float32 ImageNet-normalised."""
    lib = _load()
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    assert c == 3
    dst = np.empty((h, w, 3), np.float32)
    lib.normalize_imagenet_f32(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_long(h * w),
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return dst
