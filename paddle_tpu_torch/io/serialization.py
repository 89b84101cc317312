"""Crash-safe file writes and checked pickle loads.

Port of ``paddle_tpu/io/serialization.py``'s ``_atomic_write``,
``atomic_pickle_dump`` and ``_load_pickle``: a write streams into a
sibling temp file that is fsync'd, then one atomic ``os.replace`` and a
directory fsync, so a kill at any instant leaves the old file or the
whole new one; a load raises a ValueError naming a missing or truncated
file.
"""
from __future__ import annotations

import os
import pickle

__all__ = ["atomic_write_bytes", "atomic_pickle_dump", "load_pickle",
           "fsync_dir"]


def fsync_dir(path: str) -> None:
    """Make a rename durable: fsync the containing directory."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _atomic_write(path, write_fn):
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            write_fn(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    fsync_dir(d or ".")


def atomic_write_bytes(path, data: bytes) -> None:
    _atomic_write(path, lambda f: f.write(data))


def atomic_pickle_dump(obj, path, protocol=4) -> None:
    """Pickle ``obj`` to ``path`` through the atomic-replace protocol."""
    _atomic_write(path, lambda f: pickle.dump(obj, f, protocol=protocol))


def load_pickle(path):
    """``pickle.load``, with a ValueError naming the path for a missing
    or truncated file. Load only files this program or the JAX package
    wrote: unpickling can run code."""
    if not os.path.exists(path):
        raise ValueError(
            f"io.load: no checkpoint file at {path!r} (missing or "
            "never saved)")
    try:
        with open(path, "rb") as f:
            return pickle.load(f)
    except (EOFError, pickle.UnpicklingError) as e:
        raise ValueError(
            f"io.load: checkpoint file {path!r} is truncated or corrupt "
            f"({type(e).__name__}: {e}) — the writer was likely "
            "interrupted; re-save it") from e
