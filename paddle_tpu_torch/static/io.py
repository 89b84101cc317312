"""Static-graph checkpoint and inference-model IO.

Port of ``paddle_tpu/static/io.py``'s ``save_inference_model`` /
``load_inference_model``, ``save_persistables`` / ``load_persistables``
and ``save_program`` / ``load_program``, with the same files: the
pruned program and its feed/fetch names as a pickled dict
(``__model__``), the persistables as a pickle of name -> numpy
(``params.pdparams``), a sha256 manifest (``MANIFEST.json``), and
programs as the IR's JSON. An inference model saved by either package
loads and runs in the other.

The port saves the pruned test-mode program as it is; the JAX package
also runs its pass pipeline over it, which the port does not have (a
program so simplified still runs here: it uses the same ops).
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from ..io.serialization import (atomic_pickle_dump, atomic_write_bytes,
                                load_pickle)
from ..io.snapshot import verify_file_manifest, write_file_manifest
from .executor import Executor, Scope, global_scope, load_numpy_state
from .ir import Program, Variable

__all__ = ["save_inference_model", "load_inference_model",
           "save_persistables", "load_persistables", "save_params",
           "load_params", "save_program", "load_program"]

_PARAMS_SUFFIX = ".pdparams"
_MODEL_FILENAME = "__model__"
_BLOB_MANIFEST = "MANIFEST.json"


def _collect_persistables(program: Program, scope: Scope):
    out = {}
    for name, desc in program.global_block.vars.items():
        if desc.persistable:
            v = scope.find_var(name)
            if v is not None:
                out[name] = v.detach().cpu().numpy()
    return out


def _load_into_scope(state, executor: Executor) -> None:
    load_numpy_state(global_scope(), state, executor.device)


def save_persistables(executor: Executor, dirname: str,
                      main_program: Optional[Program] = None,
                      filename: Optional[str] = None):
    from .ir import default_main_program
    program = main_program or default_main_program()
    os.makedirs(dirname, exist_ok=True)
    path = os.path.join(dirname, filename or "params" + _PARAMS_SUFFIX)
    atomic_pickle_dump(_collect_persistables(program, global_scope()), path)
    return path


def load_persistables(executor: Executor, dirname: str,
                      main_program: Optional[Program] = None,
                      filename: Optional[str] = None):
    path = os.path.join(dirname, filename or "params" + _PARAMS_SUFFIX)
    _load_into_scope(load_pickle(path), executor)


save_params = save_persistables
load_params = load_persistables


def save_inference_model(dirname: str, feeded_var_names: Sequence[str],
                         target_vars: Sequence[Variable], executor: Executor,
                         main_program: Optional[Program] = None,
                         model_filename: Optional[str] = None,
                         params_filename: Optional[str] = None):
    """Prune the test-mode program to the feeds and targets; write it,
    the persistables it reads, and their manifest."""
    from .ir import default_main_program
    program = main_program or default_main_program()
    os.makedirs(dirname, exist_ok=True)
    fetch_names = [v.name if isinstance(v, Variable) else str(v)
                   for v in target_vars]
    pruned = program.clone(for_test=True).prune(feeded_var_names,
                                                fetch_names)
    meta = {"feed_names": list(feeded_var_names),
            "fetch_names": fetch_names}
    model_name = model_filename or _MODEL_FILENAME
    params_name = params_filename or "params" + _PARAMS_SUFFIX
    atomic_pickle_dump({"program": pruned.to_dict(), "meta": meta},
                       os.path.join(dirname, model_name))
    atomic_pickle_dump(_collect_persistables(pruned, global_scope()),
                       os.path.join(dirname, params_name))
    write_file_manifest(
        os.path.join(dirname, _BLOB_MANIFEST),
        {name: os.path.join(dirname, name)
         for name in (model_name, params_name)})
    return fetch_names


def load_inference_model(dirname: str, executor: Executor,
                         model_filename: Optional[str] = None,
                         params_filename: Optional[str] = None):
    """(program, feed names, fetch Variables) of a saved model, its
    persistables loaded into the global scope on the executor's device,
    after the manifest has verified both files."""
    verify_file_manifest(os.path.join(dirname, _BLOB_MANIFEST), dirname)
    blob = load_pickle(
        os.path.join(dirname, model_filename or _MODEL_FILENAME))
    program = Program.from_dict(blob["program"])
    meta = blob["meta"]
    state = load_pickle(
        os.path.join(dirname, params_filename or "params" + _PARAMS_SUFFIX))
    _load_into_scope({k: np.asarray(v) for k, v in state.items()}, executor)
    fetch_vars = [program.global_block.var(n) for n in meta["fetch_names"]]
    return program, meta["feed_names"], fetch_vars


def save_program(program: Program, path: str):
    """Serialize one program to a file (the IR's JSON)."""
    atomic_write_bytes(path, program.serialize_to_string())


def load_program(path: str) -> Program:
    with open(path, "rb") as f:
        return Program.parse_from_string(f.read())
