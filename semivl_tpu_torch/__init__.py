"""SemiVL in PyTorch for NVIDIA Hopper (H100).

The PyTorch counterpart of ``semivl_tpu``: the same models, weights and
evaluation, with the Pallas TPU kernels re-written by hand in CUDA C++ for
``sm_90a`` (``csrc/``). Every kernel has a plain PyTorch version beside it,
which runs for tensors on the CPU; tensors on a CUDA device always go
through the kernel.

Layout:

- ``ops/``: resize, the attention dispatcher (``attention``), the packed
  and head-split attention kernel wrappers (``flash_attention``), the fused
  VLG decoder wrappers (``fused_decoder``, ``fused_decoder_banded``), the
  fused Up stage (``fused_up``) and the kernel build helper (``_build``).
- ``models/``: ``MaskClipViT``, ``VLGHead``, ``VLM`` and ``build_model``.
- ``evaluation/``: ``Evaluator`` (``zegclip_sliding_window``), ``evaluate``
  and the IoU histograms.
- ``configs/``, ``text/``: the flagship, Cityscapes and tiny VLM
  configurations and their text embeddings.
- ``tools/``: ``fused_up_bench``.
- ``convert.py``: JAX parameter tree -> this package's ``state_dict``.

Entry points run on ``cuda`` unless the caller passes ``device='cpu'``.
"""
