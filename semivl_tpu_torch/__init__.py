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
- ``evaluation/``: ``Evaluator`` (``zegclip_sliding_window``,
  ``sliding_window``), ``evaluate`` (a prefetch thread, histograms on the
  device) and the IoU histograms.
- ``configs/``, ``text/``: the flagship, Cityscapes and tiny VLM
  configurations, the run-config generator (``configs.experiments``) and
  the text embeddings.
- ``data/``, ``datasets/``, ``native/``, ``utils/``: the host data
  pipeline, class names and palettes, the native image decode, logging.
- ``train/``: the optimizer, the SemiVL step, the loop and checkpoints.
- ``parallel/``: data parallelism over processes, one a card
  (``dist``: the process group and the step's, BatchNorm's and the
  evaluation's collectives).
- ``tools/``: the trainer CLI (``train``, one rank under torchrun), the
  config CLI (``experiments``), the multi-rank dry run
  (``dryrun_multichip``) and the kernel and evaluation benches.
- ``convert.py``: JAX parameter tree -> this package's ``state_dict``; a
  converted CLIP tree into the model.

Entry points run on ``cuda`` unless the caller passes ``device='cpu'``.
"""
