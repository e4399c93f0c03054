"""Float checks of an eager torch computation: the counterpart of the JAX
package's ``checkify.float_checks`` instrumentation of the render
(``cfg.debug_checks``; simple_spectral_tpu/render/renderer.py:52-61).

:class:`FloatChecks` is a ``TorchDispatchMode``: every aten op run inside it
is run as it would be, and then its result is read, never changed.

* NaN check: the floating outputs of the ops in :data:`NAN_OPS` must hold
  no NaN, whether or not an input held one.  The list is the aten
  counterpart of checkify's ``nan_primitives`` (jax._src.checkify):
  arithmetic, powers and roots, exponentials and logarithms, trigonometric
  and hyperbolic functions, error functions, the sigmoid, matrix products,
  reductions, cumulative ops, padding, convolution and remainders, and
  division (checkify checks ``div`` for NaN in its division check).
  Selects, gathers, copies, comparisons, min/max, abs and rounding are not
  on it, as they are not on checkify's.
* Division check: checkify flags any zero divisor of ``div``, of any
  dtype.  Here every op of :data:`DIV_OPS` whose divisor holds a zero
  raises, and so do the integer remainders of :data:`INT_REM_OPS`.

A failure raises ``FloatingPointError`` naming the op and the innermost
frame of ``simple_spectral_torch`` that ran it, the counterpart of
checkify's located error.  Work that runs outside aten, such as the CUDA
kernels launched through ``ctypes``, is not seen, as checkify does not see
inside a Pallas kernel.  Each check reads a flag back from the device, so
the checked computation is slow: a debugging aid.
"""

from __future__ import annotations

import numbers
import os
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode

NAN_OPS = frozenset({
    # arithmetic
    "add", "sub", "rsub", "mul", "div", "true_divide", "reciprocal", "addcmul", "addcdiv", "lerp",
    "remainder", "fmod",
    # powers, roots, exponentials, logarithms
    "pow", "sqrt", "rsqrt", "exp", "exp2", "expm1", "log", "log2", "log10", "log1p",
    # trigonometric and hyperbolic
    "sin", "cos", "tan", "asin", "acos", "atan", "atan2", "sinh", "cosh", "tanh", "asinh", "acosh", "atanh",
    # special functions
    "erf", "erfc", "erfinv", "sigmoid", "lgamma", "digamma", "special_i0e", "special_i1e",
    # matrix products (dot_general) and solves
    "mm", "bmm", "addmm", "addmv", "addbmm", "baddbmm", "mv", "dot", "matmul", "linalg_solve", "_linalg_solve_ex",
    # reductions and cumulative ops
    "sum", "prod", "mean", "var", "std", "norm", "linalg_vector_norm",
    "cumsum", "cumprod", "cummax", "cummin", "logcumsumexp",
    # padding and convolution
    "constant_pad_nd", "convolution",
})
DIV_OPS = frozenset({"div", "true_divide", "floor_divide", "reciprocal"})
INT_REM_OPS = frozenset({"remainder", "fmod"})

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _where() -> str:
    """The innermost frame of the package outside this module."""
    for frame in reversed(traceback.extract_stack()):
        if frame.filename.startswith(_PKG_DIR) and frame.filename != __file__:
            return f"{os.path.relpath(frame.filename, os.path.dirname(_PKG_DIR))}:{frame.lineno} in {frame.name}"
    return "outside simple_spectral_torch"


def _has_zero(x) -> bool:
    if isinstance(x, torch.Tensor):
        return bool((x == 0).any())
    return isinstance(x, numbers.Number) and x == 0


def _has_nan(out) -> bool:
    if isinstance(out, torch.Tensor):
        return out.is_floating_point() and bool(torch.isnan(out).any())
    if isinstance(out, (tuple, list)):
        return any(_has_nan(o) for o in out)
    return False


class FloatChecks(TorchDispatchMode):
    """Raise ``FloatingPointError`` at the first aten op that computes a NaN
    or divides by zero (module docstring)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        name = name[:-1] if name.endswith("_") and not name.startswith("_") else name
        integer = isinstance(args[0], torch.Tensor) and not args[0].is_floating_point()
        if name in DIV_OPS or (name in INT_REM_OPS and integer):
            divisor = args[0] if name == "reciprocal" else (args[1] if len(args) > 1 else kwargs.get("other"))
            if _has_zero(divisor):
                raise FloatingPointError(f"division by zero in aten::{name} at {_where()}")
        out = func(*args, **kwargs)
        if name in NAN_OPS and _has_nan(out):
            raise FloatingPointError(f"NaN generated by aten::{name} at {_where()}")
        return out
