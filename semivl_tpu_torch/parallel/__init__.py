"""Data parallelism over processes, one per card (the counterpart of
``semivl_tpu/parallel/``): ``dist`` sets up the process group and holds the
step's, BatchNorm's and the evaluation's collectives."""
