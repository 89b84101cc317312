"""Unique-name generation: ``generate``, ``switch`` and ``guard``.

Port of ``paddle_tpu/utils/unique_name.py``. A name is
``f"{key}_{n}"`` with ``n`` the count of earlier names under ``key``,
the JAX package's counter rule, so that a program built by both
packages under ``guard()`` names every variable alike. The counter pool
is this module's own (the port's eager layers do not draw names from
it).
"""
from __future__ import annotations

import contextlib

__all__ = ["generate", "switch", "guard"]

_counters: dict = {}
_prefix_stack: list = []


def generate(key: str) -> str:
    n = _counters.get(key, 0)
    _counters[key] = n + 1
    name = f"{key}_{n}"
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
