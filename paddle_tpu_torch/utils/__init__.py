"""Small utilities of the port: ``unique_name``."""
from . import unique_name

__all__ = ["unique_name"]
