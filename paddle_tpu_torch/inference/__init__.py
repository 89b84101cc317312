"""Inference serving: the serving error taxonomy and the paged-KV
decode engine (``inference.decode``)."""
from .serving import (DeadlineExceeded, EngineStopped, KVRestoreError,
                      Overloaded, RequestFailed, ServingError)

__all__ = ["DeadlineExceeded", "EngineStopped", "KVRestoreError",
           "Overloaded", "RequestFailed", "ServingError"]
