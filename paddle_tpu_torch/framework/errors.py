"""Typed error hierarchy and the ``enforce`` helpers.

Port of ``paddle_tpu/framework/errors.py``: the reference's
PADDLE_ENFORCE error codes as Python exceptions, each also an instance
of the builtin it refines (``InvalidArgumentError`` is a ``ValueError``,
``NotFoundError`` a ``KeyError``, ...), so callers may catch either.
"""
from __future__ import annotations


class EnforceNotMet(RuntimeError):
    """Base framework error (reference: platform::EnforceNotMet)."""

    code = "LEGACY"


class InvalidArgumentError(EnforceNotMet, ValueError):
    code = "INVALID_ARGUMENT"


class NotFoundError(EnforceNotMet, KeyError):
    code = "NOT_FOUND"


class OutOfRangeError(EnforceNotMet, IndexError):
    code = "OUT_OF_RANGE"


class EOFException(OutOfRangeError):
    """A reader is exhausted (``fluid.core.EOFException``)."""


class AlreadyExistsError(EnforceNotMet):
    code = "ALREADY_EXISTS"


class ResourceExhaustedError(EnforceNotMet, MemoryError):
    code = "RESOURCE_EXHAUSTED"


class PreconditionNotMetError(EnforceNotMet):
    code = "PRECONDITION_NOT_MET"


class PermissionDeniedError(EnforceNotMet):
    code = "PERMISSION_DENIED"


class ExecutionTimeoutError(EnforceNotMet, TimeoutError):
    code = "EXECUTION_TIMEOUT"


class UnimplementedError(EnforceNotMet, NotImplementedError):
    code = "UNIMPLEMENTED"


class UnavailableError(EnforceNotMet):
    code = "UNAVAILABLE"


class FatalError(EnforceNotMet):
    code = "FATAL"


class ExternalError(EnforceNotMet):
    code = "EXTERNAL"


def enforce(cond, msg="Enforce failed", exc=InvalidArgumentError):
    if not cond:
        raise exc(msg)


def enforce_eq(a, b, msg=None, exc=InvalidArgumentError):
    if a != b:
        raise exc(msg or f"Expected {a!r} == {b!r}")


def enforce_shape_match(shape_a, shape_b, msg=None):
    if tuple(shape_a) != tuple(shape_b):
        raise InvalidArgumentError(
            msg or f"Shape mismatch: {tuple(shape_a)} vs {tuple(shape_b)}"
        )
