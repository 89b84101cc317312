"""Operators of the port: beam search (``ops.beam_search``, the
counterpart of ``paddle_tpu/ops/beam_search.py``); the hand-written CUDA
kernels live in ``ops/cuda`` (the counterpart of
``paddle_tpu/ops/pallas``)."""
from . import beam_search
from .beam_search import beam_search_decode, beam_search_step

__all__ = ["beam_search", "beam_search_decode", "beam_search_step"]
