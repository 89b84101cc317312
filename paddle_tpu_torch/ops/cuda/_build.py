"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled at
first use by ``nvcc`` for Hopper (``sm_90a``) into its own shared
library, loaded with :mod:`ctypes`. The flash sources also build a
second library each (``VARIANTS``: the same source and entry points with
``-DFLASH_WIDE``) holding their head widths 192 and 256, so that those
instantiations compile in parallel with the rest. Libraries land in ``build/cuda/``
at the repository root (git-ignored), named by a hash of the source
and the flags, so an edited source rebuilds and an unchanged one is
reused. A file lock keeps two processes from building the same library
at once. :func:`build_all` starts one ``nvcc`` per source together and
waits for all of them.

No ``--use_fast_math``: the sampling kernel must match its plain
version bit for bit, and approximate division or exponentials would
break that (and the attention kernel's tolerance).
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "VARIANTS", "sources",
           "load", "build_all", "entry", "check"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "cuda"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

# libraries built from another library's source with extra flags:
# name -> (source name, flags)
VARIANTS = {"flash_attention_wide": ("flash_attention", ("-DFLASH_WIDE",)),
            "flash_short_wide": ("flash_short", ("-DFLASH_WIDE",))}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def sources() -> List[str]:
    """Kernel library names: one per ``csrc/*.cu`` and one per variant."""
    return sorted([p.stem for p in CSRC.glob("*.cu")] + list(VARIANTS))


def _source(name: str):
    """(the ``.cu`` file, its extra nvcc flags) of library ``name``."""
    base, flags = VARIANTS.get(name, (name, ()))
    return CSRC / f"{base}.cu", list(flags)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _lib_path(name: str) -> Path:
    src, flags = _source(name)
    h = hashlib.sha256()
    h.update(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS + flags).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str, ptxas_verbose: bool):
    """Start nvcc for ``name`` unless its library exists; returns
    (path, process or None, lock file)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _lib_path(name)
    lock = open(BUILD_DIR / f"{name}.lock", "w")
    fcntl.flock(lock, fcntl.LOCK_EX)
    if out.exists():
        return out, None, lock
    tmp = out.with_suffix(f".tmp{os.getpid()}")
    src, flags = _source(name)
    cmd = [_nvcc(), *NVCC_FLAGS, *flags, "-I", str(CSRC)]
    if ptxas_verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, (proc, tmp), lock


def _finish(name: str, out: Path, job, lock) -> str:
    log = ""
    try:
        if job is not None:
            proc, tmp = job
            log = proc.communicate()[0]
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}.cu "
                                   f"(exit {proc.returncode}):\n{log}")
            os.replace(tmp, out)
    finally:
        fcntl.flock(lock, fcntl.LOCK_UN)
        lock.close()
    return log


def build_all(ptxas_verbose: bool = False) -> Dict[str, str]:
    """Build every kernel library, one nvcc per source, all started at
    once; load them. Returns each kernel's compiler output (empty when
    the library was already built)."""
    with _LOCK:
        jobs = {n: _start(n, ptxas_verbose) for n in sources()
                if n not in _LIBS}
        logs = {}
        for n, (out, job, lock) in jobs.items():
            logs[n] = _finish(n, out, job, lock)
            _LIBS[n] = ctypes.CDLL(str(out))
        return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, built on first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        if name not in _LIBS:
            out, job, lock = _start(name, False)
            _finish(name, out, job, lock)
            _LIBS[name] = ctypes.CDLL(str(out))
        return _LIBS[name]


def entry(name: str, fn_name: str, argtypes) -> ctypes._CFuncPtr:
    """C entry point ``fn_name`` of kernel library ``name`` with its
    argument types declared (``c_void_p`` for pointers and the stream)
    and an int (``cudaError_t``) result."""
    fn = getattr(load(name), fn_name)
    if fn.argtypes is None:
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return fn


def check(name: str, err: int, what: str) -> None:
    """Raise when an entry point of kernel library ``name`` returned a
    nonzero ``cudaError_t`` (its ``cudaGetLastError()`` right after the
    launch)."""
    if err != 0:
        fn = load(name).kernel_error_string
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError "
                           f"{err} ({fn(err).decode()})")
