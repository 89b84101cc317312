"""The ``fluid.dygraph`` names of the eager surface (port of the part of
``paddle_tpu/dygraph.py`` the framework core carries): ``enabled``,
``guard``, ``to_variable``, ``save_dygraph``/``load_dygraph`` (over
``io.serialization``), ``BackwardStrategy``, ``no_grad`` and ``grad``,
plus ``Layer``, its containers and the lr schedulers under their fluid
names.

``declarative``/``dygraph_to_static_func`` and ``TracedLayer`` raise:
dy2static is port slice 9 (ROADMAP queue 1 item 2). ``GRUUnit``,
``NCE``, ``PRelu`` and ``TreeConv`` are slice 10's ``nn`` bullet
(ROADMAP queue 1 item 3).
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from .autograd import grad  # noqa: F401
from .framework import mode
from .framework.mode import (disable_dygraph, enable_dygraph,  # noqa: F401
                             in_dygraph_mode)
from .framework.tape import no_grad  # noqa: F401
from .framework.tensor import to_tensor
from .io.serialization import load_dygraph, save_dygraph  # noqa: F401
from .nn import Layer, LayerList, Sequential
from .optimizer.lr import (  # noqa: F401
    CosineAnnealingDecay as CosineDecay, ExponentialDecay,
    InverseTimeDecay, LambdaDecay, LinearWarmup as LinearLrWarmup,
    MultiStepDecay, NaturalExpDecay, NoamDecay, PiecewiseDecay,
    PolynomialDecay, ReduceOnPlateau as ReduceLROnPlateau, StepDecay)

__all__ = ["guard", "enabled", "to_variable", "no_grad", "grad",
           "save_dygraph", "load_dygraph", "BackwardStrategy",
           "TracedLayer", "declarative", "dygraph_to_static_func", "Layer",
           "Sequential", "LayerList"]


def enabled() -> bool:
    return in_dygraph_mode()


@contextlib.contextmanager
def guard(place=None):
    """Eager mode inside the block (the default mode); ``place`` is
    accepted for the fluid signature (the device is ``set_device``'s)."""
    prev = mode._static_mode
    mode.disable_static()
    try:
        yield
    finally:
        mode._static_mode = prev


def to_variable(value, name=None, zero_copy=None, dtype=None):
    """``to_tensor`` under its fluid name (a numpy copy of anything that
    is not a tensor)."""
    t = to_tensor(value if isinstance(value, torch.Tensor)
                  else np.asarray(value), dtype=dtype)
    if name:
        t.name = name
    return t


class BackwardStrategy:
    """The fluid knob ``sort_sum_gradient``: stored. PyTorch's autograd
    accumulates a tensor's gradient in a fixed order, deterministic by
    construction."""

    def __init__(self):
        self.sort_sum_gradient = False


def declarative(fn=None, **kwargs):
    raise NotImplementedError("declarative / dygraph_to_static_func: "
                              "dy2static is port slice 9 (ROADMAP queue 1 "
                              "item 2)")


dygraph_to_static_func = declarative


class TracedLayer:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError("TracedLayer: dy2static is port slice 9 "
                                  "(ROADMAP queue 1 item 2)")

    @staticmethod
    def trace(layer, inputs):
        raise NotImplementedError("TracedLayer.trace: dy2static is port "
                                  "slice 9 (ROADMAP queue 1 item 2)")

