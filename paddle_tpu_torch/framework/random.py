"""Random state for the port: the global seed, per-device default
generators, and the per-step generators a training step folds from
``(seed, step)``.

Counterpart of ``paddle_tpu/framework/random.py`` (``seed``,
``rng_scope``, ``next_rng_key``) and of ``jit.py``'s
``jax.random.fold_in(make_key(seed), step)``. JAX keys become
:class:`torch.Generator` objects: a :class:`StepRNG` holds one generator
on the compute device (dropout masks drawn with ``torch.rand``) and one
on the host (the 64-bit seeds handed to kernels that generate their own
bits, such as flash attention's in-kernel Philox dropout), so drawing a
kernel seed never waits for the device.

The bits cannot match JAX's: threefry/rbg keys and PyTorch's Philox
generators give different numbers from the same seed, and the flash
kernel's mask is a Philox function of (seed, row, column) rather than
of the TPU's tile coordinates. Parity tests therefore run with dropout
at 0 or feed both sides the same numpy noise; a seeded run of the port
replays itself exactly.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["seed", "initial_seed", "default_generator", "fold_in", "StepRNG",
           "rng_scope", "current_rng", "generator_for", "next_rng_key",
           "Generator"]

_MASK64 = (1 << 64) - 1
_state = threading.local()
_GLOBAL = {"seed": 0, "gens": {}}
_LOCK = threading.Lock()


def seed(s: int) -> None:
    """Reseed the global state (``paddle.seed``): later default
    generators, parameter initialisation and the random ops included,
    start from ``s``."""
    with _LOCK:
        _GLOBAL["seed"] = int(s)
        _GLOBAL["gens"] = {}


def initial_seed() -> int:
    """The seed of the last :func:`seed` call (0 before any)."""
    with _LOCK:
        return _GLOBAL["seed"]


def default_generator(device) -> torch.Generator:
    """The global generator for ``device``, seeded from :func:`seed` on
    first use after each reseed."""
    device = torch.device(device)
    key = (device.type, device.index)
    with _LOCK:
        gen = _GLOBAL["gens"].get(key)
        if gen is None:
            gen = torch.Generator(device=device)
            gen.manual_seed(_GLOBAL["seed"])
            _GLOBAL["gens"][key] = gen
        return gen


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def fold_in(seed_: int, data: int) -> int:
    """A 64-bit seed that is a fixed function of ``(seed_, data)``, the
    counterpart of ``jax.random.fold_in``."""
    return _splitmix64(_splitmix64(int(seed_) & _MASK64) ^ (int(data)
                                                           & _MASK64))


class StepRNG:
    """The random state of one step: a device generator for masks drawn
    by PyTorch ops and a host generator for kernel seeds, both seeded
    from ``seed_``."""

    def __init__(self, seed_: int, device):
        self.seed = int(seed_) & _MASK64
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.seed)
        self._host = torch.Generator()
        self._host.manual_seed(self.seed ^ 0x5DEECE66D)

    def next_seed(self) -> int:
        """A fresh non-negative 63-bit seed, drawn on the host."""
        return int(torch.randint(0, (1 << 63) - 1, (1,),
                                 generator=self._host).item())


Generator = torch.Generator


class rng_scope:
    """Make ``key_or_seed`` (a :class:`StepRNG`, or an int seeding one
    on the default device) the random state of stochastic ops inside the
    ``with`` block (``paddle_tpu.framework.random.rng_scope``)."""

    def __init__(self, key_or_seed):
        if isinstance(key_or_seed, int):
            from .._device import resolve_device

            key_or_seed = StepRNG(key_or_seed, resolve_device(None))
        self.rng = key_or_seed

    def __enter__(self):
        stack = getattr(_state, "stack", None)
        if stack is None:
            stack = _state.stack = []
        stack.append(self.rng)
        return self.rng

    def __exit__(self, *exc):
        _state.stack.pop()
        return False


def current_rng(device) -> StepRNG:
    """The innermost :class:`rng_scope`'s state, else a state drawn from
    the global generator of ``device``."""
    stack = getattr(_state, "stack", None)
    if stack:
        return stack[-1]
    gen = default_generator("cpu")
    s = int(torch.randint(0, (1 << 63) - 1, (1,), generator=gen).item())
    return StepRNG(s, device)


def generator_for(device) -> torch.Generator:
    """The generator a random op on ``device`` draws from: the innermost
    :class:`rng_scope`'s when it is on that device, else the device's
    global generator (reseeded by :func:`seed`)."""
    device = torch.device(device)
    stack = getattr(_state, "stack", None)
    if stack:
        rng = stack[-1]
        if rng.device.type == device.type and \
                (rng.device.index or 0) == (device.index or 0):
            return rng.generator
    return default_generator(device)


def next_rng_key() -> torch.Generator:
    """The generator of the next random op on the default device (the
    JAX package's key; PyTorch's generators are stateful)."""
    from .._device import resolve_device

    return generator_for(resolve_device(None))
