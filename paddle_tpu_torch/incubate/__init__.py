"""``incubate`` (port of ``paddle_tpu/incubate``): the contrib layers'
``fused_embedding_seq_pool`` so far; the rest of the package is a
later port slice."""
from . import layers  # noqa: F401
from .layers import fused_embedding_seq_pool  # noqa: F401

__all__ = ["layers", "fused_embedding_seq_pool"]
