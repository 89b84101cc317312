"""File IO of the port: crash-safe writes (``serialization``) and the
sha256 manifest of a saved model (``snapshot``)."""
from . import serialization, snapshot

__all__ = ["serialization", "snapshot"]
