"""Execution-mode flags (port of ``paddle_tpu/framework/mode.py``).

Eager ("dygraph") is the default; ``enable_static`` flips the advisory
flag that ``in_dynamic_mode()``/``in_dygraph_mode()`` report. The port's
static graph is built explicitly (``static.program_guard``) and never
reads this flag, so it only answers ``paddle.enable_static()`` and mode
introspection."""
from __future__ import annotations

_static_mode = False


def enable_static():
    global _static_mode
    _static_mode = True


def disable_static():
    global _static_mode
    _static_mode = False


# fluid spellings (enable_dygraph == disable_static)
def enable_dygraph(place=None):
    disable_static()


def disable_dygraph():
    enable_static()


enable_imperative = enable_dygraph
disable_imperative = disable_dygraph


def in_dynamic_mode() -> bool:
    return not _static_mode


in_dygraph_mode = in_dynamic_mode
