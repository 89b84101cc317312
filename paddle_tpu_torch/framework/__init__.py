"""Framework core of the port: the random state (``framework.random``)
and the flag registry (``framework.flags``)."""
from . import flags, random
from .flags import get_flags, set_flags
from .random import seed

__all__ = ["flags", "random", "seed", "get_flags", "set_flags"]
