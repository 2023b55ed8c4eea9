"""Inference and evaluation (counterpart of
``semivl_tpu/evaluation/predict.py``) in the reference's five modes.

``zegclip_sliding_window`` (VOC): windows lie on an edge-aligned grid
(crop, stride); their logits are averaged by visit count, resized to the
label size with bilinear ``align_corners=True`` and reduced by argmax
(reference third_party/unimatch/supervised.py:69-102). Images whose short
side is at least the crop stay on the device from upload to argmax; a
smaller image takes the host route, which feeds each window at its clipped
size as the reference does.

``sliding_window`` (Cityscapes): windows start every int(crop * 2 / 3)
pixels from the top-left corner, the ones at the bottom and right edges
clipped to the image and fed at that natural size; the softmax
probabilities of every window are summed on the device and reduced by
argmax at image size (reference supervised.py:104-117; JAX
``_sliding_device``). A 1024x2048 image at crop 801 gives 8 windows of
4 shapes (801^2, 801x446, 490x801, 490x446).

``original`` runs the whole image; ``center_crop`` its central crop, with
the reference's negative-offset sliver for an image smaller than the crop
(``evaluate`` crops the label map with the same arithmetic;
supervised.py:120-124); ``padded_sliding_window`` zero-pads each window
to the crop in normalised space (a uint8 image is normalised on the host
first) and sums the windows' softmax probabilities (supervised.py:41-67).
These three, ``sliding_window``'s host route (JAX ``_sliding``) and every
``predict(..., return_logits=True)`` run on the host route: the windows'
logits are fetched and the canvas kept in numpy, as JAX's host routes
keep it.

Crops of one shape run through the model in exact power-of-two batches of
at most 32.

``evaluate`` pipelines the host side as JAX's does (``semivl_tpu/evaluation/
predict.py:788-924``): a prefetch thread loads image i+1 and uploads it and
its label map (``preupload``, ``preupload_mask``: pinned memory, a side
stream) while image i's windows run, and on the device routes the
intersection/union histograms are counted on the device (``_hist``) into a
(3, C) int32 buffer (``zero_hist``, ``predict_hist_into``) that is fetched
once every ``eval_hist_flush_every`` images. Given ``process_count`` > 1,
each rank evaluates its stride of the set and the ranks' integer histograms
are summed by one ``all_reduce`` (JAX's ``process_allgather``, :909-916).
"""

import logging
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from semivl_tpu_torch.data import transforms as T
from semivl_tpu_torch.device import resolve_device
from semivl_tpu_torch.evaluation.metrics import (
    intersection_and_union,
    miou_from_histograms,
)
from semivl_tpu_torch.models.vlm import IMAGENET_MEAN, IMAGENET_STD
from semivl_tpu_torch.ops.resize import (_axis_weights, axis_weights,
                                         device_constant)
from semivl_tpu_torch.parallel import dist


def _np_resize_bilinear(x, out_hw, align_corners):
    """Host bilinear resize of a (B, C, H, W) numpy array."""
    wh = _axis_weights(out_hw[0], x.shape[2], 'bilinear', align_corners,
                       'float32')
    ww = _axis_weights(out_hw[1], x.shape[3], 'bilinear', align_corners,
                       'float32')
    return np.matmul(np.matmul(wh[None, None], x), ww.T[None, None])


def _np_softmax(x, axis):
    e = np.exp(x - x.max(axis=axis, keepdims=True))
    return e / e.sum(axis=axis, keepdims=True)


def center_crop_box(h, w, size):
    """The rows and columns of ``center_crop`` mode (reference
    supervised.py:120-124): offsets (h - size) // 2 and (w - size) // 2,
    negative for an image smaller than the crop, so that numpy's slicing
    keeps an edge sliver as torch's does there."""
    sh, sw = (h - size) // 2, (w - size) // 2
    return slice(sh, sh + size), slice(sw, sw + size)


def _chunk_sizes(n, max_chunk=32):
    """n as descending power-of-two chunk sizes (each <= max_chunk), e.g.
    7 -> [4, 2, 1], 33 -> [32, 1]: exact, no padded crops."""
    sizes = []
    while n > 0:
        c = min(max_chunk, 1 << (n.bit_length() - 1))
        sizes.append(c)
        n -= c
    return sizes


class Uploaded:
    """A tensor copied to the card on a side stream (``Evaluator.preupload``):
    ``get()`` makes the current stream wait for the copy and returns the
    tensor."""

    def __init__(self, tensor, event=None):
        self.tensor, self.event = tensor, event

    def get(self):
        if self.event is not None:
            stream = torch.cuda.current_stream(self.tensor.device)
            stream.wait_event(self.event)
            self.tensor.record_stream(stream)
            self.event = None
        return self.tensor


class Evaluator:
    """Runs ``model`` (a ``models.vlm.VLM`` on ``device``) over windows."""

    def __init__(self, model, text_feats, cfg, device=None):
        self.device = resolve_device(device)
        self.model = model
        self.text = torch.as_tensor(np.asarray(text_feats, np.float32),
                                    device=self.device)
        self.cfg = cfg
        self.nclass = cfg['nclass']
        self._streams = {}   # upload thread -> its side stream

    def _upload(self, arr):
        """A host array on the evaluator's device. On the card: from pinned
        memory on a side stream of the calling thread, without waiting for
        it (``Uploaded.get`` orders the use after the copy)."""
        t = torch.from_numpy(np.require(arr, requirements=('C', 'W')))
        if self.device.type != 'cuda':
            return Uploaded(t.to(self.device))
        key = threading.get_ident()
        if key not in self._streams:
            self._streams[key] = torch.cuda.Stream(self.device)
        stream = self._streams[key]
        with torch.cuda.stream(stream):
            dev = t.pin_memory().to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(stream)
        return Uploaded(dev, event)

    def preupload(self, img):
        """Upload a (1, H, W, 3) host image (JAX ``preupload``, :148): called
        from ``evaluate``'s prefetch thread so that the copy of image i+1
        overlaps image i's windows; feeds ``predict`` and
        ``predict_hist_into`` as ``img_dev``."""
        return self._upload(img[0])

    def preupload_mask(self, mask):
        """Upload an (H, W) label map as uint8 (class ids and the ignore
        value 255 fit a byte; JAX ``preupload_mask``, :173) for the device
        histograms."""
        return self._upload(np.asarray(mask).astype(np.uint8))

    def zero_hist(self):
        """A fresh (3, C) int32 zero accumulator on the device (JAX
        ``zero_hist``, :527)."""
        return torch.zeros((3, self.nclass), dtype=torch.int32,
                           device=self.device)

    def _hist(self, pred, mask):
        """(intersection, union, target) (3, C) int32 of a device label map
        against a uint8 label map (255 ignored), the exact integer counts
        of ``metrics.intersection_and_union`` (JAX ``_hist``, :445): a
        label value at or above C that is not 255 counts nowhere, as there."""
        n = self.nclass
        pred = pred.reshape(-1).long()
        mask = mask.reshape(-1).long()
        valid = mask != 255
        over = torch.full_like(pred, n)
        ones = torch.ones_like(pred)

        def hist(src):   # a scatter: bincount would wait for its max
            return torch.zeros(n + 1, dtype=torch.long, device=src.device) \
                .scatter_add_(0, src.clamp(max=n), ones)[:n]

        ai = hist(torch.where((pred == mask) & valid, pred, over))
        ap = hist(torch.where(valid, pred, over))
        at = hist(torch.where(valid, mask, over))
        return torch.stack([ai, ap + at - ai, at]).int()

    def predict_hist_into(self, acc, img, mask, mode, img_dev=None,
                          mask_dev=None):
        """Predict on the device and add the histograms into ``acc`` (JAX
        ``predict_hist_into``, :536); returns ``acc``, or None where this
        mode and geometry take the host route (``acc`` untouched). No
        per-image transfer to the host."""
        if not self.use_device(img, mode):
            return None
        pred = self.predict_device(img, mask.shape, mode, img_dev)
        if mask_dev is None:
            mask_dev = self.preupload_mask(mask)
        mask_dev = mask_dev.get() if isinstance(mask_dev, Uploaded) \
            else mask_dev
        return acc.add_(self._hist(pred, mask_dev))

    def _to_model_input(self, x):
        """uint8 crops are normalised on the device (/255, then ImageNet
        mean/std); float crops pass through as already normalised."""
        if x.dtype != torch.uint8:
            return x
        mean = device_constant('imagenet_mean',
                               lambda: np.asarray(IMAGENET_MEAN), x.device)
        std = device_constant('imagenet_std',
                              lambda: np.asarray(IMAGENET_STD), x.device)
        return (x.float() / 255.0 - mean) / std

    @torch.no_grad()
    def _forward(self, crops):
        """(n, h, w, 3) crops on the device -> (n, C, h, w) float32 logits,
        in exact power-of-two chunks."""
        outs, off = [], 0
        for c in _chunk_sizes(crops.shape[0]):
            x = self._to_model_input(crops[off:off + c])
            outs.append(self.model(x, self.text).float())
            off += c
        return torch.cat(outs)

    def use_device(self, img, mode):
        """Whether ``mode`` on this geometry keeps the canvas on the device
        (the small-image zegclip route runs on the host)."""
        if mode == 'sliding_window':
            return True
        return (mode == 'zegclip_sliding_window'
                and min(img.shape[1:3]) >= self.cfg['crop_size'])

    def predict(self, img, mask_shape, mode, img_dev=None,
                return_logits=False):
        """img: (1, H, W, 3) numpy, uint8 or normalised float; ``img_dev``:
        it uploaded (``preupload``). Returns the (1, h_mask, w_mask) int64
        prediction; with ``return_logits`` also the accumulated (1, C, h,
        w) float32 score map (reference supervised.py:129-132), from the
        host route."""
        if mode == 'padded_sliding_window' and img.dtype == np.uint8:
            # zero padding must be zero in normalised space (JAX
            # predict.py:570-578)
            img = T.normalize(img[0])[None]
        if self.use_device(img, mode) and not return_logits:
            return self.predict_device(img, mask_shape, mode, img_dev)[
                None].cpu().numpy()
        if mode == 'zegclip_sliding_window':
            pred, logits = self._zegclip_sliding(img, mask_shape)
        elif mode == 'sliding_window':
            pred, logits = self._sliding(img, mask_shape)
        elif mode == 'padded_sliding_window':
            pred, logits = self._padded_sliding(img, mask_shape)
        elif mode in ('original', 'center_crop'):
            if mode == 'center_crop':
                rows, cols = center_crop_box(*img.shape[1:3],
                                             self.cfg['crop_size'])
                img = img[:, rows, cols]
            logits = self._host_forward(img)
            pred = logits.argmax(axis=1)
        else:
            raise ValueError(mode)
        return (pred, logits) if return_logits else pred

    def predict_device(self, img, mask_shape, mode, img_dev=None):
        """The (h_mask, w_mask) int64 prediction on the device, of a mode and
        geometry that ``use_device`` keeps there."""
        img_dev = self._image_on_device(img, img_dev)
        if mode == 'sliding_window':
            return self._sliding_device(img_dev, mask_shape)
        return self._zegclip_sliding_device(img_dev, mask_shape)

    def _image_on_device(self, img, img_dev):
        """(H, W, 3) on the device: ``img_dev`` (an ``Uploaded`` or a
        tensor), else ``img`` uploaded now."""
        if img_dev is None:
            return torch.from_numpy(np.ascontiguousarray(img[0])).to(
                self.device)
        return img_dev.get() if isinstance(img_dev, Uploaded) else img_dev

    def _zegclip_coords(self, h_img, w_img):
        crop = self.cfg['crop_size']
        stride = self.cfg['stride']
        h_grids = max(h_img - crop + stride - 1, 0) // stride + 1
        w_grids = max(w_img - crop + stride - 1, 0) // stride + 1
        coords = []
        for hi in range(h_grids):
            for wi in range(w_grids):
                y1 = min(hi * stride + crop, h_img) - crop
                x1 = min(wi * stride + crop, w_img) - crop
                coords.append((max(y1, 0), max(x1, 0)))
        return coords

    def _zegclip_sliding_device(self, img_dev, mask_shape):
        """Slice the windows of the image on the device, accumulate the
        canvas, divide by the visit count, resize and take the argmax on
        the device: the (h_mask, w_mask) label map."""
        crop = self.cfg['crop_size']
        h_img, w_img = img_dev.shape[:2]
        coords = self._zegclip_coords(h_img, w_img)
        crops = torch.stack([img_dev[y:y + crop, x:x + crop]
                             for y, x in coords])
        logits = self._forward(crops)
        canvas = torch.zeros((self.nclass, h_img, w_img), device=self.device)
        count = torch.zeros((h_img, w_img), device=self.device)
        for i, (y, x) in enumerate(coords):
            canvas[:, y:y + crop, x:x + crop] += logits[i]
            count[y:y + crop, x:x + crop] += 1
        canvas /= count
        wh = axis_weights(mask_shape[0], h_img, 'bilinear', True, self.device)
        ww = axis_weights(mask_shape[1], w_img, 'bilinear', True, self.device)
        final = torch.matmul(torch.matmul(wh, canvas), ww.t())
        return final.argmax(dim=0)

    def sliding_windows(self, h, w):
        """{(crop h, crop w): [(y, x), ...]} of ``sliding_window`` mode, in
        the reference's row-major order."""
        grid = self.cfg['crop_size']
        stride = int(grid * 2 / 3)
        shapes = {}
        for y in range(0, h, stride):
            for x in range(0, w, stride):
                shape = (min(h, y + grid) - y, min(w, x + grid) - x)
                shapes.setdefault(shape, []).append((y, x))
        return shapes

    def _sliding_device(self, img_dev, mask_shape):
        """Per window shape, run the crops of the image on the device, add
        their softmax probabilities into the canvas, take the argmax on the
        device: the (H, W) label map."""
        h, w = img_dev.shape[:2]
        if tuple(mask_shape) != (h, w):
            raise ValueError(f'sliding_window predicts at image size {(h, w)}'
                             f', the label is {tuple(mask_shape)}')
        canvas = torch.zeros((self.nclass, h, w), device=self.device)
        for (ch, cw), coords in self.sliding_windows(h, w).items():
            crops = torch.stack([img_dev[y:y + ch, x:x + cw]
                                 for y, x in coords])
            probs = torch.softmax(self._forward(crops), dim=1)
            for i, (y, x) in enumerate(coords):
                canvas[:, y:y + ch, x:x + cw] += probs[i]
        return canvas.argmax(dim=0)

    def _host_forward(self, crops):
        """(n, h, w, 3) numpy crops -> (n, C, h, w) float32 numpy logits."""
        return self._forward(torch.from_numpy(np.require(
            crops, requirements=('C', 'W'))).to(self.device)).cpu().numpy()

    def _zegclip_sliding(self, img, mask_shape):
        """Host route: windows at their clipped size, canvas in numpy."""
        crop = self.cfg['crop_size']
        _, h_img, w_img, _ = img.shape
        coords = self._zegclip_coords(h_img, w_img)
        crops = np.concatenate([img[:, y:y + crop, x:x + crop]
                                for y, x in coords])
        logits = self._host_forward(crops)
        preds = np.zeros((1, self.nclass, h_img, w_img), np.float32)
        count = np.zeros((1, 1, h_img, w_img), np.float32)
        for i, (y, x) in enumerate(coords):
            preds[0, :, y:y + crop, x:x + crop] += logits[i]
            count[0, :, y:y + crop, x:x + crop] += 1
        preds /= count
        final = _np_resize_bilinear(preds, mask_shape, align_corners=True)
        return final.argmax(axis=1), final

    def _sliding(self, img, mask_shape):
        """Host route of ``sliding_window`` (JAX ``_sliding``): the softmax
        probabilities of each window, crops of one shape batched, summed
        into a numpy canvas at image size."""
        h, w = img.shape[1:3]
        if tuple(mask_shape) != (h, w):
            raise ValueError(f'sliding_window predicts at image size {(h, w)}'
                             f', the label is {tuple(mask_shape)}')
        final = np.zeros((1, self.nclass, h, w), np.float32)
        for (ch, cw), coords in self.sliding_windows(h, w).items():
            probs = _np_softmax(self._host_forward(np.concatenate(
                [img[:, y:y + ch, x:x + cw] for y, x in coords])), axis=1)
            for i, (y, x) in enumerate(coords):
                final[0, :, y:y + ch, x:x + cw] += probs[i]
        return final.argmax(axis=1), final

    def _padded_sliding(self, img, mask_shape):
        """Windows every ``stride`` pixels (a fraction of the crop if below
        1) from the top-left corner, each zero-padded to the crop at its
        bottom and right, one batch; the softmax probabilities of each
        window's own pixels summed at image size (reference
        supervised.py:41-67)."""
        grid = self.cfg['crop_size']
        stride = self.cfg['stride']
        if stride < 1:
            stride = int(grid * stride)
        h, w = img.shape[1:3]
        if tuple(mask_shape) != (h, w):
            raise ValueError(f'padded_sliding_window predicts at image size '
                             f'{(h, w)}, the label is {tuple(mask_shape)}')
        boxes = [(y, x, min(h, y + grid), min(w, x + grid))
                 for y in range(0, h, stride) for x in range(0, w, stride)]
        crops = np.zeros((len(boxes), grid, grid, 3), img.dtype)
        for i, (y1, x1, y2, x2) in enumerate(boxes):
            crops[i, :y2 - y1, :x2 - x1] = img[0, y1:y2, x1:x2]
        probs = _np_softmax(self._host_forward(crops), axis=1)
        final = np.zeros((1, self.nclass, h, w), np.float32)
        for i, (y1, x1, y2, x2) in enumerate(boxes):
            final[0, :, y1:y2, x1:x2] += probs[i, :, :y2 - y1, :x2 - x1]
        return final.argmax(axis=1), final


def evaluate_histograms(evaluator, dataset, mode, cfg, indices=None,
                        progress=None, process_index=0, process_count=1):
    """The summed intersection and union histograms, each (C,) int64,
    over ``dataset`` (``len`` and ``get(i)`` giving ``{'img': (H, W, 3),
    'mask': (H, W)}``) or its ``indices``, pipelined as JAX's ``evaluate``
    (``semivl_tpu/evaluation/predict.py:788-924``):

    - with ``process_count`` > 1 (ranks of a process group), this rank
      (``process_index``) takes ``range(process_index, len(dataset),
      process_count)`` and the histograms returned are every rank's summed
      (one ``all_reduce`` on the evaluator's device); ``indices`` are then
      refused, since every rank would count them;
    - with ``cfg['eval_prefetch']`` (default on) a thread loads image i+1
      and uploads it and its label map while image i runs;
    - with ``cfg['eval_device_metrics']`` (default on) the device routes
      count the histograms on the device into a (3, C) int32 buffer,
      fetched every ``cfg['eval_hist_flush_every']`` images (default 256:
      below the int32 bound at 1024 x 2048);
    - an image that takes the host route (zegclip with a short side below
      the crop, and every image of the ``original``, ``center_crop`` and
      ``padded_sliding_window`` modes) is predicted and counted on the
      host, and their number is logged as a warning at the end;
    - ``center_crop`` crops the label map as it crops the image.

    ``progress(i)`` is called after each image."""
    nclass = cfg['nclass']
    inter_sum = np.zeros(nclass, np.int64)
    union_sum = np.zeros(nclass, np.int64)
    if indices is None:
        idxs = list(range(process_index, len(dataset), process_count))
    elif process_count > 1:
        raise ValueError('indices with process_count > 1: every rank would '
                         'count them; the ranks stride the set themselves')
    else:
        idxs = list(indices)
    dev_metrics = bool(cfg.get('eval_device_metrics', True))
    use_prefetch = bool(cfg.get('eval_prefetch', True)) and len(idxs) > 1
    flush_every = max(1, int(cfg.get('eval_hist_flush_every', 256)))

    def load(i):
        sample = dataset.get(i)
        img, mask = sample['img'][None], sample['mask']
        if mode == 'center_crop':
            mask = mask[center_crop_box(*mask.shape, cfg['crop_size'])]
        img_dev = mask_dev = None
        if evaluator.use_device(img, mode):
            img_dev = evaluator.preupload(img)
            if dev_metrics:
                mask_dev = evaluator.preupload_mask(mask)
        return img, mask, img_dev, mask_dev

    hist_acc, acc_images, n_host = None, 0, 0

    def flush():
        nonlocal hist_acc, acc_images
        if hist_acc is not None:
            counts = hist_acc.cpu().numpy().astype(np.int64)
            inter_sum[:] += counts[0]
            union_sum[:] += counts[1]
        hist_acc, acc_images = None, 0

    executor = (ThreadPoolExecutor(1, thread_name_prefix='eval_prefetch')
                if use_prefetch else None)
    try:
        fut = executor.submit(load, idxs[0]) if executor else None
        for j, i in enumerate(idxs):
            img, mask, img_dev, mask_dev = (fut.result() if executor
                                            else load(i))
            if executor and j + 1 < len(idxs):
                fut = executor.submit(load, idxs[j + 1])
            acc = None
            if mask_dev is not None:
                acc = evaluator.predict_hist_into(
                    evaluator.zero_hist() if hist_acc is None else hist_acc,
                    img, mask, mode, img_dev=img_dev, mask_dev=mask_dev)
            if acc is not None:
                hist_acc, acc_images = acc, acc_images + 1
                if acc_images >= flush_every:
                    flush()
            else:
                n_host += not evaluator.use_device(img, mode)
                pred = evaluator.predict(img, mask.shape, mode,
                                         img_dev=img_dev)
                inter, union, _ = intersection_and_union(pred[0], mask,
                                                         nclass)
                inter_sum += inter
                union_sum += union
            if progress is not None:
                progress(i)
        flush()
    finally:
        if executor is not None:
            executor.shutdown(wait=True)
    if n_host:
        logging.getLogger('global').warning(
            'evaluate: %d/%d images routed to the slow host predict path '
            '(image min side < crop_size=%s, or a mode/geometry without '
            'device support) - check img_scale/val resize if this is '
            'unexpected', n_host, len(idxs), cfg.get('crop_size'))
    if process_count > 1:
        both = dist.all_reduce_sum_(torch.from_numpy(
            np.stack([inter_sum, union_sum])).to(evaluator.device))
        inter_sum, union_sum = both.cpu().numpy()
    return inter_sum, union_sum


def evaluate(evaluator, dataset, mode, cfg, indices=None, progress=None,
             process_index=0, process_count=1):
    """mIoU and per-class IoU over ``dataset`` from its summed
    intersection/union histograms (reference supervised.py:135-164;
    ``evaluate_histograms``, whose rank's stride and cross-rank sum the
    last two arguments set), the same on every rank."""
    return miou_from_histograms(*evaluate_histograms(
        evaluator, dataset, mode, cfg, indices, progress, process_index,
        process_count))
