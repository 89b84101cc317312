"""Inference serving on the card: the bucketed static-graph predictor
and its continuous-batching ``ServingEngine`` (``serving.py``), the
serving error taxonomy, and the paged-KV decode engine
(``inference.decode``).

    from paddle_tpu_torch.inference import (AnalysisPredictor,
                                            ServingEngine)

    pred = AnalysisPredictor(model_dir, batch_buckets=(1, 2, 4, 8))
    pred.warm()                          # every bucket once
    eng = ServingEngine(pred).start()    # continuous batching thread
    logits, = eng.infer({"img": batch})  # numpy in, numpy out

``Config``/``Predictor``/``create_predictor`` of the JAX package load a
``jit.save`` StableHLO export, which the port does not have: a later
port slice adds them.
"""
from . import decode
from .decode import DecodeEngine, DecodeModelConfig
from .serving import (AnalysisPredictor, DeadlineExceeded, EngineStopped,
                      KVRestoreError, Overloaded, RequestFailed,
                      ServingEngine, ServingError, ServingHealthServer,
                      install_sigterm_drain)

__all__ = [
    "AnalysisPredictor", "ServingEngine", "ServingHealthServer",
    "ServingError", "Overloaded", "DeadlineExceeded", "EngineStopped",
    "RequestFailed", "KVRestoreError", "install_sigterm_drain", "decode",
    "DecodeEngine", "DecodeModelConfig",
]
