"""Multi-process runtime of the port: rank and world size, process-group
set-up and ``spawn`` (port of ``paddle_tpu/distributed/__init__.py:28-45``,
``parallel.py:17-32`` and ``launch.py:355``).

The JAX package is single-controller SPMD: one process drives every
device of a mesh. Its PyTorch counterpart is one process per rank over
``torch.distributed``, so ``init_parallel_env`` joins a process group
and ``spawn`` starts the ranks. The backend is the caller's choice and
never guessed: ``"nccl"`` where each rank has its own GPU, ``"gloo"``
for ranks that share one card (NCCL refuses two ranks on one GPU) or
run on the CPU.
"""
from .launch import spawn
from .parallel import (ParallelEnv, get_rank, get_world_size,
                       init_parallel_env, is_initialized)

__all__ = ["get_rank", "get_world_size", "init_parallel_env",
           "is_initialized", "ParallelEnv", "spawn"]
