"""Operators of the port; the hand-written CUDA kernels live in
``ops/cuda`` (the counterpart of ``paddle_tpu/ops/pallas``)."""
