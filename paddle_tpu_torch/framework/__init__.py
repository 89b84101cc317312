"""Framework core of the port; so far the random state
(``framework.random``)."""
from . import random
from .random import seed

__all__ = ["random", "seed"]
