"""Unique-name generation: ``generate``, ``switch`` and ``guard``.

Port of ``paddle_tpu/utils/unique_name.py``. A name is
``f"{key}_{n}"`` with ``n`` the count of earlier names under ``key``,
the JAX package's counter rule, so that a program built by both
packages under ``guard()`` names every variable alike. The counter pool
is this module's own; the port's eager layers draw their names and
their parameters' from it too (:func:`next_name`), as the JAX package's
layers draw from its pool.
"""
from __future__ import annotations

import contextlib

__all__ = ["generate", "next_name", "switch", "guard"]

_counters: dict = {}
_prefix_stack: list = []


def next_name(key: str) -> str:
    """``f"{key}_{n}"``, n the count of earlier names under ``key`` (no
    prefix: the JAX ``nn.layer._unique_name``)."""
    n = _counters.get(key, 0)
    _counters[key] = n + 1
    return f"{key}_{n}"


def generate(key: str) -> str:
    name = next_name(key)
    if _prefix_stack:
        return "".join(_prefix_stack) + name
    return name


def switch(new_counters=None):
    """Replace the counter pool; returns the previous one."""
    old = dict(_counters)
    _counters.clear()
    if new_counters:
        _counters.update(new_counters)
    return old


@contextlib.contextmanager
def guard(new_generator=None):
    old = switch({})
    try:
        yield
    finally:
        switch(old)
