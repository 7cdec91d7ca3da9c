"""Numerical sanitizers (counterpart of ``orp_tpu/utils/debug.py``).

The JAX package's pair is ``jax_debug_nans`` and ``checkify``'s float
checks. Here both are a ``TorchDispatchMode`` that inspects every operator's
floating output as it is produced:

- ``nan_debug()``: raise on the first operator whose output holds a NaN,
  naming the operator;
- ``checked(fn)``: ``checked_fn(*args)`` runs ``fn`` under the same mode,
  records the first NaN or Inf in an error object instead of raising, and
  returns ``(err, out)``; ``err.throw()`` raises it.

These are debug tools: the check reads each operator's output back to the
host, so it synchronizes with the device once per operator.
(``torch.autograd.detect_anomaly`` checks only the backward pass, so it is
not the counterpart.)
"""

from __future__ import annotations

import contextlib

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode


def _float_outputs(out):
    return [t for t in pytree.tree_leaves(out)
            if isinstance(t, torch.Tensor) and (t.is_floating_point() or t.is_complex())]


class _FloatCheck(TorchDispatchMode):
    """Calls each operator, then ``on_bad(what, op)`` for a floating output
    holding a NaN (``what="nan"``) or, with ``inf=True``, an Inf. With
    ``once=True`` only the first is reported and later operators are not
    read back."""

    def __init__(self, on_bad, *, inf: bool, once: bool):
        super().__init__()
        self.on_bad, self.inf, self.once, self.done = on_bad, inf, once, False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in ([] if self.done else _float_outputs(out)):
            what = ("nan" if bool(torch.isnan(t).any()) else
                    "inf" if self.inf and bool(torch.isinf(t).any()) else None)
            if what is not None:
                self.done = self.once
                self.on_bad(what, func)
                break
        return out


@contextlib.contextmanager
def nan_debug():
    """Within the block, any operator that produces a NaN raises
    ``FloatingPointError`` naming the operator."""

    def raise_(what, op):
        raise FloatingPointError(f"invalid value ({what}) encountered in {op}")

    with _FloatCheck(raise_, inf=False, once=False):
        yield


class CheckError:
    """The error carrier of :func:`checked`: ``get()`` is the recorded message
    (None when the run was clean); ``throw()`` raises it."""

    def __init__(self):
        self.message: str | None = None

    def get(self) -> str | None:
        return self.message

    def throw(self) -> None:
        if self.message is not None:
            raise FloatingPointError(self.message)


def checked(fn):
    """Wrap ``fn`` with NaN/Inf checks: ``checked_fn(*args, **kwargs)`` returns
    ``(err, out)``, where ``err`` records the first operator that produced a
    NaN or an Inf; call ``err.throw()`` to surface it."""

    def checked_fn(*args, **kwargs):
        err = CheckError()

        def record(what, op):
            err.message = f"{what} generated by primitive: {op}."

        with _FloatCheck(record, inf=True, once=True):
            out = fn(*args, **kwargs)
        return err, out

    return checked_fn
