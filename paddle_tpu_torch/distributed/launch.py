"""``spawn``: start ``nprocs`` ranks of one function (port of
``paddle_tpu/distributed/launch.py:355``).

As in the JAX package each rank is a ``multiprocessing`` process with
``PADDLE_TRAINER_ID`` and ``PADDLE_TRAINERS_NUM`` set; the port adds
``PADDLE_DIST_INIT_METHOD``, the rendezvous that ``init_parallel_env``
reads, and uses the ``spawn`` start method (CUDA cannot be forked).
Unlike the JAX version it always joins, with a timeout, and returns
each rank's return value (picklable, sent back over a queue): a rank
that exits non-zero, or a join that outlasts the timeout, terminates
the others and raises.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import queue
import socket
import time

from .parallel import INIT_ENV, RANK_ENV, WORLD_ENV, is_initialized

__all__ = ["spawn"]


def _free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _entry(rank, nprocs, init_method, tasks, results):
    os.environ.update({RANK_ENV: str(rank), WORLD_ENV: str(nprocs),
                       INIT_ENV: init_method})
    func, args = tasks.get()
    value = func(*args)
    if is_initialized():
        import torch.distributed as dist

        dist.destroy_process_group()
    results.put((rank, value))


def _stop(procs):
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(10)
        if p.is_alive():
            p.kill()
            p.join(10)


def spawn(func, args=(), nprocs=1, init_method=None, timeout=600.0):
    """Run ``func(*args)`` in ``nprocs`` new processes, rank ``r`` with
    ``PADDLE_TRAINER_ID=r``, and return their return values in rank
    order. ``func`` must be importable by name (module level).
    ``init_method`` defaults to ``tcp://localhost:<free port>``. Raises
    ``RuntimeError`` when a rank exits non-zero and ``TimeoutError``
    after ``timeout`` seconds; either way every rank is stopped."""
    ctx = mp.get_context("spawn")
    init_method = init_method or f"tcp://localhost:{_free_port()}"
    # the function and its arguments go over a queue once every rank has
    # started: as Process arguments they are written to each child before
    # the next one starts, so large ones would serialise the start-ups
    tasks, results = ctx.Queue(), ctx.Queue()
    procs = [ctx.Process(target=_entry, args=(r, nprocs, init_method, tasks,
                                               results), name=f"rank{r}")
             for r in range(nprocs)]
    got = {}
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        for _ in procs:
            tasks.put((func, tuple(args)))
        while len(got) < nprocs:
            try:          # drain before join: a full pipe blocks the child
                rank, value = results.get(timeout=0.2)
                got[rank] = value
                continue
            except queue.Empty:
                pass
            bad = [p for p in procs if p.exitcode not in (None, 0)]
            if bad:
                raise RuntimeError(
                    "spawn: " + ", ".join(f"{p.name} exited {p.exitcode}"
                                          for p in bad))
            if time.monotonic() > deadline:
                raise TimeoutError(f"spawn: {nprocs} ranks did not finish "
                                   f"within {timeout} s (done: "
                                   f"{sorted(got)})")
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        _stop(procs)
        for q in (tasks, results):
            q.close()
            q.cancel_join_thread()
    return [got[r] for r in range(nprocs)]
