"""Crash-safe file writes, checked pickle loads, and ``save``/``load``.

Port of ``paddle_tpu/io/serialization.py``'s ``_atomic_write``,
``atomic_pickle_dump``, ``_load_pickle``, ``save``, ``load``,
``save_dygraph`` and ``load_dygraph`` (pickles of numpy state, the JAX
package's format): a write streams into a
sibling temp file that is fsync'd, then one atomic ``os.replace`` and a
directory fsync, so a kill at any instant leaves the old file or the
whole new one; a load raises a ValueError naming a missing or truncated
file.
"""
from __future__ import annotations

import os
import pickle

__all__ = ["atomic_write_bytes", "atomic_pickle_dump", "load_pickle",
           "fsync_dir", "save", "load", "save_dygraph", "load_dygraph"]


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


# ---------------------------------------------------------------------------
# paddle.save / paddle.load (the JAX package's .pdparams / .pdopt files)
# ---------------------------------------------------------------------------
def _to_numpy_state(obj):
    """Tensors (anywhere in dicts, lists and tuples, or a ``state_dict()``
    of an object that has one) as numpy arrays, the JAX package's file
    content; bfloat16 tensors as their exact float32 values."""
    import torch

    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    if isinstance(obj, dict):
        return {k: _to_numpy_state(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_numpy_state(v) for v in obj)
    if hasattr(obj, "state_dict") and callable(obj.state_dict):
        return _to_numpy_state(obj.state_dict())
    return obj


def save(obj, path, protocol=4, **configs):
    """Pickle ``obj`` with its tensors as numpy arrays (the JAX
    ``io.save`` format: either package loads the other's files)."""
    atomic_pickle_dump(_to_numpy_state(obj), path, protocol=protocol)


def load(path, **configs):
    """What :func:`save` wrote (numpy arrays for tensors; a layer's
    ``set_state_dict`` takes them)."""
    return load_pickle(path)


def save_dygraph(state_dict, model_path):
    """``{path}.pdopt`` for an optimizer's state (a ``step`` entry or
    ``name@slot`` keys), else ``{path}.pdparams``."""
    suffix = ".pdparams"
    if any("moment" in k or k == "step" or "@" in k for k in state_dict):
        suffix = ".pdopt"
    save(state_dict, model_path + suffix)


def load_dygraph(model_path, **configs):
    """``(params, opt)`` from ``{path}.pdparams`` / ``{path}.pdopt``
    (a suffixed path is accepted); raises when neither exists."""
    for suffix in (".pdparams", ".pdopt"):
        if model_path.endswith(suffix):
            model_path = model_path[:-len(suffix)]
    params = opt = None
    if os.path.exists(model_path + ".pdparams"):
        params = load(model_path + ".pdparams")
    if os.path.exists(model_path + ".pdopt"):
        opt = load(model_path + ".pdopt")
    if params is None and opt is None:
        raise ValueError(f"load_dygraph: neither {model_path}.pdparams nor "
                         f"{model_path}.pdopt exists")
    return params, opt
