"""Typed errors and enforce helpers (port of paddle_tpu/core/errors.py,
copied: the module is plain Python). Paddle's enforce macros become
Python exceptions with the same typed taxonomy."""
from __future__ import annotations


class EnforceNotMet(RuntimeError):
    """Base framework error (reference: platform::EnforceNotMet)."""


class InvalidArgumentError(EnforceNotMet, ValueError):
    pass


class NotFoundError(EnforceNotMet, KeyError):
    pass


class OutOfRangeError(EnforceNotMet, IndexError):
    pass


class AlreadyExistsError(EnforceNotMet):
    pass


class ResourceExhaustedError(EnforceNotMet, MemoryError):
    pass


class PreconditionNotMetError(EnforceNotMet):
    pass


class PermissionDeniedError(EnforceNotMet):
    pass


class ExecutionTimeoutError(EnforceNotMet, TimeoutError):
    pass


class UnimplementedError(EnforceNotMet, NotImplementedError):
    pass


class UnavailableError(EnforceNotMet):
    pass


class FatalError(EnforceNotMet):
    pass


class ExternalError(EnforceNotMet):
    pass


def enforce(cond, message: str, exc=InvalidArgumentError):
    """PADDLE_ENFORCE analogue."""
    if not cond:
        raise exc(message)


def enforce_eq(a, b, message: str = "", exc=InvalidArgumentError):
    if a != b:
        raise exc(f"Expected {a!r} == {b!r}. {message}")


def enforce_gt(a, b, message: str = "", exc=InvalidArgumentError):
    if not a > b:
        raise exc(f"Expected {a!r} > {b!r}. {message}")


def enforce_not_none(v, message: str = "", exc=NotFoundError):
    if v is None:
        raise exc(message or "Expected a non-None value")
    return v
