"""Numerical guards: structured NaN / division-by-zero detection for stage
graphs.

Counterpart of ``rs_image_segmentation_tpu.utils.guards``. The JAX package
wraps a function with ``jax.experimental.checkify`` (``float_checks``:
``NaNError`` and ``DivisionByZeroError``); here :func:`checked` runs it
under a ``TorchDispatchMode`` that sees every aten op and raises
:class:`CheckError`, naming the op,

* when an op's floating-point output holds a NaN that none of its inputs
  held (so ``nan_to_num(log(-1))`` raises at ``log``, as checkify does; a
  NaN that an input already carried is not flagged again, where checkify
  flags every NaN output of a primitive that can make one);
* when a division-family op has a zero divisor, float or integer:
  ``div``, ``floor_divide``, ``remainder``, ``fmod`` and ``reciprocal``
  (``scalar / tensor`` dispatches as ``reciprocal`` and a multiply).

Ops that return uninitialised memory (``empty`` and its kin) are not
read. The port's CUDA kernels launch through ``ctypes``
(``ops._build``), below the dispatcher, so the mode does not see inside
them, as checkify does not see inside a ``pallas_call``; it checks the
ops around them. Each check reads a flag back to the host after every op:
a debugging tool, never on a timed path.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

_aten = torch.ops.aten
_DIVISIONS = {_aten.div, _aten.div_, _aten.floor_divide, _aten.floor_divide_,
              _aten.remainder, _aten.remainder_, _aten.fmod, _aten.fmod_}
_RECIPROCALS = {_aten.reciprocal, _aten.reciprocal_}
_UNINITIALISED = {_aten.empty, _aten.empty_like, _aten.empty_strided,
                  _aten.new_empty, _aten.new_empty_strided}


class CheckError(RuntimeError):
    """A failed guard: a generated NaN, a zero divisor or a failed
    :func:`assert_finite`."""


def sanitize(x: torch.Tensor, value: float = 0.0) -> torch.Tensor:
    """NaN -> value, +/-Inf -> finite max/min (``torch.nan_to_num``)."""
    return torch.nan_to_num(x, nan=value)


def assert_finite(x: torch.Tensor, name: str = "array") -> torch.Tensor:
    """Raise :class:`CheckError` unless every element is finite; returns
    x."""
    if not bool(torch.isfinite(x).all()):
        raise CheckError(f"{name} contains NaN/Inf")
    return x


def _has_nan(t) -> bool:
    return (isinstance(t, torch.Tensor) and t.is_floating_point()
            and bool(torch.isnan(t).any()))


def _is_zero(d) -> bool:
    if isinstance(d, torch.Tensor):
        return bool((d == 0).any())
    return isinstance(d, (int, float)) and d == 0


class _FloatChecks(TorchDispatchMode):
    """Raises on a generated NaN or a zero divisor (module docstring)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func.overloadpacket
        if packet in _DIVISIONS and len(args) > 1 and _is_zero(args[1]):
            raise CheckError(f"division by zero in {func}")
        if packet in _RECIPROCALS and _is_zero(args[0]):
            raise CheckError(f"division by zero in {func}")
        nan_in = packet not in _UNINITIALISED and any(
            _has_nan(t) for t in tree_leaves((args, kwargs)))
        out = func(*args, **kwargs)
        if packet not in _UNINITIALISED and not nan_in and any(
                _has_nan(t) for t in tree_leaves(out)):
            raise CheckError(f"NaN generated by {func}")
        return out


def checked(fn: Callable, *static_argnames: str) -> Callable:
    """Wrap ``fn`` so a NaN produced anywhere inside, or a division by
    zero, raises :class:`CheckError` on call. Use for debugging stage
    graphs:

        stack = checked(hierarchical_stack)(bands)

    ``static_argnames`` is accepted for the JAX signature; eager PyTorch
    traces nothing, so every argument is taken as given."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with _FloatChecks():
            return fn(*args, **kwargs)

    return wrapper
