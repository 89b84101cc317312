"""The op library of the port (``paddle_tpu/ops``): creation, math,
manipulation, logic, linalg, search and debug ops over torch, beam
search (``ops.beam_search``), and the hand-written CUDA kernels in
``ops/cuda`` (the counterpart of ``paddle_tpu/ops/pallas``). The
sequence ops (``ops/sequence.py``) are slice 10's."""
from . import (beam_search, creation, debug, linalg, logic, manipulation,
               math, search)
from .beam_search import beam_search_decode, beam_search_step
from .creation import *  # noqa: F401,F403
from .debug import Assert, Print, py_func  # noqa: F401
from .linalg import *  # noqa: F401,F403
from .logic import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403
from .search import *  # noqa: F401,F403
from ..framework.op import primitive  # noqa: E402,F401
from ..framework.random import next_rng_key  # noqa: E402,F401
from ..framework.tensor import Tensor, unwrap  # noqa: E402,F401
