"""Framework core of the port: the random state (``framework.random``),
the flag registry (``framework.flags``), the IR's dtype names
(``framework.dtype``) and places (``framework.place``)."""
from . import dtype, flags, place, random
from .flags import get_flags, set_flags
from .place import CPUPlace, CUDAPlace
from .random import seed

__all__ = ["dtype", "flags", "place", "random", "seed", "get_flags",
           "set_flags", "CPUPlace", "CUDAPlace"]
