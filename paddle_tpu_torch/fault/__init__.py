"""Fault handling of the port: the retry policy (``retry.py``)."""
from .retry import Backoff, Retrier

__all__ = ["Backoff", "Retrier"]
