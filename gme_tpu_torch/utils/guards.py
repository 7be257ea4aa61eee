"""Numeric-sanity guards: checks that raise only when asked to.

Counterpart of `gme_tpu/utils/guards.py`.  The JAX package's `check` is a
`checkify` check compiled in only when enabled at trace time, so its
production path yields NaN parameters for a degenerate fit where a checked
run raises.  Here the checks are plain Python: `check` reads its predicate
only inside `debug_checks()` (a tensor predicate is read back to the host
then, and never otherwise), and `run_checked` runs a function under
`debug_checks()` and then rejects NaN and inf in its floating outputs.

Usage:
    from gme_tpu_torch.utils.guards import run_checked
    out = run_checked(gme_pipeline_step, prev, curr, cfg)   # raises on NaN /
                                                            # degenerate fit

The flag is a context variable, so a thread or task that enters
`debug_checks()` enables the checks for itself only.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Callable

import torch

_ENABLED = contextvars.ContextVar("gme_tpu_torch_debug_checks", default=False)


class CheckError(ValueError):
    """A guard check failed, or a checked run produced NaN or inf."""


def checks_enabled() -> bool:
    return _ENABLED.get()


@contextlib.contextmanager
def debug_checks():
    """Enable guard checks for the calls made inside this context."""
    token = _ENABLED.set(True)
    try:
        yield
    finally:
        _ENABLED.reset(token)


def check(pred, msg: str) -> None:
    """Raise `CheckError(msg)` unless every element of `pred` holds, inside
    `debug_checks()` only; outside it `pred` is not read.  Call sites live
    in the numeric core (the affine fit)."""
    if _ENABLED.get() and not bool(torch.as_tensor(pred).all()):
        raise CheckError(msg)


def _floating_leaves(out, path="output"):
    if isinstance(out, torch.Tensor):
        if out.is_floating_point():
            yield path, out
    elif isinstance(out, dict):
        for k, v in out.items():
            yield from _floating_leaves(v, f"{path}[{k!r}]")
    elif isinstance(out, (list, tuple)):
        for i, v in enumerate(out):
            yield from _floating_leaves(v, f"{path}[{i}]")


def run_checked(fn: Callable, *args: Any, **kwargs: Any):
    """Run `fn` with guard checks enabled, then raise `CheckError` if any
    floating tensor of its output (nested in dicts, lists and tuples) holds
    NaN or inf; returns the output otherwise."""
    with debug_checks():
        out = fn(*args, **kwargs)
    for path, t in _floating_leaves(out):
        if not bool(torch.isfinite(t).all()):
            raise CheckError(f"non-finite value (NaN or inf) in {path}")
    return out
