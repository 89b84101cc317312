"""Rank, world size and process-group set-up from the environment that
:func:`~paddle_tpu_torch.distributed.spawn` (or a launcher) sets:
``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM`` and
``PADDLE_DIST_INIT_METHOD`` (a ``tcp://host:port`` or ``file://path``
rendezvous)."""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

__all__ = ["get_rank", "get_world_size", "init_parallel_env",
           "is_initialized", "ParallelEnv", "BACKENDS"]

BACKENDS = ("nccl", "gloo")
_TIMEOUT_S = 300          # a collective that waits longer fails the rank
RANK_ENV, WORLD_ENV, INIT_ENV = ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM",
                                 "PADDLE_DIST_INIT_METHOD")


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_world_size() -> int:
    """Ranks in the default group, else ``PADDLE_TRAINERS_NUM`` (1)."""
    if is_initialized():
        return dist.get_world_size()
    return int(os.environ.get(WORLD_ENV, 1))


def get_rank() -> int:
    """This process's rank in the default group, else
    ``PADDLE_TRAINER_ID`` (0)."""
    if is_initialized():
        return dist.get_rank()
    return int(os.environ.get(RANK_ENV, 0))


class ParallelEnv:
    """Rank, world size and backend of this process."""

    def __init__(self):
        self.rank = get_rank()
        self.world_size = get_world_size()
        self.local_rank = self.rank
        self.nranks = self.world_size
        self.backend = dist.get_backend() if is_initialized() else None
        self.dev_id = torch.cuda.current_device() \
            if self.backend == "nccl" else 0


def init_parallel_env(backend: str) -> ParallelEnv:
    """Join the default process group of ``PADDLE_TRAINERS_NUM`` ranks at
    ``PADDLE_DIST_INIT_METHOD`` as rank ``PADDLE_TRAINER_ID``. ``backend``
    is ``"nccl"`` (each rank takes GPU ``rank % device_count``) or
    ``"gloo"`` (the caller places its tensors; ranks may share a card).
    A world of one needs no rendezvous and joins no group."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    world = int(os.environ.get(WORLD_ENV, 1))
    if world > 1 and not is_initialized():
        init = os.environ.get(INIT_ENV)
        if not init:
            raise RuntimeError(f"{INIT_ENV} is not set: start the ranks "
                               f"with distributed.spawn or set it to a "
                               f"tcp:// or file:// rendezvous")
        rank = int(os.environ[RANK_ENV])
        if backend == "nccl":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            backend, init_method=init, world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=_TIMEOUT_S))
    return ParallelEnv()
