"""LLM decode serving on the card: paged KV cache + the paged attention
kernel + continuous prefill/decode scheduling.

Quickstart::

    from paddle_tpu_torch.inference.decode import (DecodeEngine,
                                                   DecodeModelConfig)

    cfg = DecodeModelConfig(vocab_size=32000, n_layers=24, n_heads=16,
                            head_dim=128, ffn_dim=8192, max_context=2048)
    eng = DecodeEngine(cfg, n_pages=512, page_size=128,
                       max_pages_per_seq=16, max_batch=8,
                       kv_codec="int8")   # device defaults to the card
    eng.warm()                      # build the CUDA kernels
    eng.start()                     # continuous-batching scheduler
    tokens = eng.generate([1, 5, 9], max_new_tokens=32)
"""
from .engine import DecodeEngine
from .kv_cache import PageTableManager, alloc_kv_pool, alloc_kv_scales
from .model import (DecodeModelConfig, init_decode_params,
                    params_from_numpy, reference_generate)
from .scheduler import DecodeRequest, DecodeScheduler

__all__ = [
    "DecodeEngine", "DecodeModelConfig", "DecodeRequest",
    "DecodeScheduler", "PageTableManager", "alloc_kv_pool",
    "alloc_kv_scales", "init_decode_params", "params_from_numpy",
    "reference_generate",
]
