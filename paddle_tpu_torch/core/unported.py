"""Reference parameters that the port keeps in place without supporting.

A ported function or class keeps the reference's positional parameter
order (ROADMAP.md, Signatures), so a call written against paddle_tpu
binds the same way here. A parameter whose feature the port has not
ported yet stays in its place and takes only its default:
`require_defaults` raises NotImplementedError for any other value.
"""
from __future__ import annotations

__all__ = ["require_defaults"]


def _is_default(value, default) -> bool:
    if default is None:
        return value is None
    return value == default


def require_defaults(where: str, **given) -> None:
    """given: name=(value, default). Raises NotImplementedError naming
    every parameter of `where` whose value is not its default."""
    bad = [f"{name}={value!r}" for name, (value, default) in given.items()
           if not _is_default(value, default)]
    if bad:
        raise NotImplementedError(
            f"{where}: {', '.join(bad)} is not ported yet (only the "
            f"default is accepted)")
