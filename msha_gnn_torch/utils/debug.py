"""Numerical-debug switches (``msha_gnn_tpu/utils/debug.py``).

The JAX package turns on ``jax_debug_nans``, which raises at the primitive
that produced a NaN.  Here :func:`nan_guard` has two parts:

* a :class:`~torch.utils._python_dispatch.TorchDispatchMode`
  (:class:`NanCheckMode`) that checks every operator's floating outputs
  and raises naming the operator (the allocators that return
  uninitialised memory, ``empty`` and its kin, are not checked);
* ``torch.autograd.set_detect_anomaly(True, check_nan=True)`` for the
  backward, which runs outside the mode (on the autograd engine's
  threads), and raises naming the backward function.

The port's CUDA kernels are launched through ``ctypes``, outside the
dispatcher, so while a guard is on each wrapper checks its own outputs
(:func:`check_kernel`).  Off, the guard costs one integer test a launch.
The mode is thread-local: it watches the thread that entered it.
"""

from __future__ import annotations

import contextlib
import os

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# the guards entered in this process; the kernels' wrappers read it
_active = 0
# the guard nan_guard_from_env turned on, None while it has not
_env_mode = None

# operators whose outputs are uninitialised memory, NaN bits included
_UNINITIALISED = frozenset(("empty", "empty_like", "empty_strided",
                            "empty_permuted", "new_empty",
                            "new_empty_strided"))


def _has_nan(outputs) -> bool:
    return any(isinstance(t, torch.Tensor) and t.is_floating_point()
               and t.numel() > 0 and bool(torch.isnan(t).any())
               for t in tree_leaves(outputs))


class NanCheckMode(TorchDispatchMode):
    """Raises :class:`FloatingPointError` at the first operator whose
    floating output holds a NaN, naming the operator."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ not in _UNINITIALISED \
                and _has_nan(out):
            raise FloatingPointError(f"NaN in the output of {func}")
        return out


def check_kernel(name: str, *outputs: torch.Tensor) -> None:
    """Under a guard, raise :class:`FloatingPointError` when an output of
    the kernel ``name`` holds a NaN; nothing when no guard is on."""
    if _active and _has_nan(outputs):
        raise FloatingPointError(f"NaN in the output of the kernel {name}")


def _enable():
    global _active
    _active += 1
    torch.autograd.set_detect_anomaly(True, check_nan=True)


@contextlib.contextmanager
def nan_guard(enable: bool = True):
    """Within the block, raise at the first operator, kernel or backward
    function that produces a NaN (CI, debugging)."""
    global _active
    if not enable:
        yield
        return
    anomaly = torch.is_anomaly_enabled()
    check_nan = torch.is_anomaly_check_nan_enabled()
    _enable()
    try:
        with NanCheckMode():
            yield
    finally:
        _active -= 1
        torch.autograd.set_detect_anomaly(anomaly, check_nan=check_nan)


def nan_guard_from_env(var: str = "MSHA_NAN_GUARD") -> bool:
    """When the environment variable ``var`` is set, turn the guard on for
    the rest of the process (the calling thread's operators, every
    backward, every kernel); returns whether it is on.  A second call
    leaves the guard as the first turned it on, as setting
    ``jax_debug_nans`` again does."""
    global _env_mode
    if not os.environ.get(var):
        return False
    if _env_mode is None:
        _enable()
        _env_mode = NanCheckMode()
        _env_mode.__enter__()
    return True
