"""The port's NaN guard (``utils/debug.py``) on the CPU.

The JAX package's ``nan_guard`` turns on ``jax_debug_nans``, which raises
at the primitive that produced a NaN; the port's raises at the operator
(a dispatch mode), at the backward function (anomaly detection) or at
the kernel wrapper (``check_kernel``) that produced it.  The process-wide
switch (``MSHA_NAN_GUARD``) runs in a fresh interpreter, since it stays on
for the life of the process.
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msha_gnn_tpu.utils.debug import nan_guard as jax_nan_guard
from msha_gnn_torch.data import synthetic_flow
from msha_gnn_torch.training import msha_task
from msha_gnn_torch.utils import debug
from msha_gnn_torch.utils.debug import (check_kernel, nan_guard,
                                        nan_guard_from_env)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def msha():
    fg = synthetic_flow(200, 6, 10, 4, 1200, seed=0)
    return msha_task(fg, in_features=8, out_features=4, device="cpu")


def test_a_clean_run_passes_and_settings_are_restored(msha):
    task, model = msha
    gen = torch.Generator().manual_seed(0)
    with nan_guard():
        assert debug._active == 1
        out, _ = task.forward(model, torch.arange(32), train=True,
                              generator=gen)
        out.sum().backward()
        torch.empty(4096)          # uninitialised memory is not checked
    assert debug._active == 0
    assert not torch.is_anomaly_enabled()
    with nan_guard(enable=False):
        assert debug._active == 0


def test_an_injected_nan_raises_at_an_operator(msha):
    """A NaN in one source feature: under the guard the forward raises
    naming the operator that first carries it; without, it runs (and the
    NaN reaches the scores)."""
    task, model = msha
    saved = model.Sfeatures.detach().clone()
    with torch.no_grad():
        model.Sfeatures[5, 1] = float("nan")
    try:
        with pytest.raises(FloatingPointError, match=r"NaN in the output "
                           r"of aten\.\w+"):
            with nan_guard():
                task.forward(model, torch.arange(16), train=False)
        out, _ = task.forward(model, torch.arange(16), train=False)
        assert out.shape == (16, 6) and bool(torch.isnan(out).any())
    finally:
        with torch.no_grad():
            model.Sfeatures.copy_(saved)


def test_the_producing_operator_is_named():
    x = torch.tensor([1.0, -1.0])
    with pytest.raises(FloatingPointError, match=r"aten\.log"):
        with nan_guard():
            torch.log(x)
    # as jax_debug_nans raises at the primitive
    with pytest.raises(FloatingPointError):
        with jax_nan_guard():
            jax.jit(jnp.log)(jnp.asarray(np.array([1.0, -1.0], np.float32)))


class _NanGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x * 2.0

    @staticmethod
    def backward(ctx, g):
        return g * float("nan")


def test_a_nan_in_the_backward_raises():
    """On the CPU the backward runs on the calling thread, so the mode
    names the operator first; on CUDA the autograd engine's device thread
    runs it, outside the mode, where anomaly detection (on under the
    guard) names the backward function."""
    x = torch.ones(3, requires_grad=True)
    with pytest.raises((FloatingPointError, RuntimeError),
                       match=r"aten\.mul|_NanGradBackward"):
        with nan_guard():
            assert torch.is_anomaly_enabled()
            assert torch.is_anomaly_check_nan_enabled()
            _NanGrad.apply(x).sum().backward()
    with pytest.raises(RuntimeError, match="_NanGradBackward"):
        with torch.autograd.set_detect_anomaly(True, check_nan=True):
            _NanGrad.apply(x).sum().backward()
    _NanGrad.apply(x).sum().backward()    # unguarded: a NaN gradient
    assert bool(torch.isnan(x.grad).all())


def test_kernel_wrappers_check_their_outputs_only_under_the_guard():
    bad = torch.tensor([0.0, float("nan")])
    check_kernel("csr_spmm_f32", torch.zeros(2), bad)
    with nan_guard():
        check_kernel("csr_spmm_f32", torch.zeros(2))
        with pytest.raises(FloatingPointError, match="kernel csr_spmm_f32"):
            check_kernel("csr_spmm_f32", torch.zeros(2), bad)


def test_the_environment_switch(monkeypatch):
    monkeypatch.delenv("MSHA_NAN_GUARD_UNSET", raising=False)
    assert nan_guard_from_env("MSHA_NAN_GUARD_UNSET") is False
    assert debug._active == 0
    script = textwrap.dedent("""
        import sys, torch
        from msha_gnn_torch.utils.debug import nan_guard_from_env
        assert nan_guard_from_env() is True
        assert torch.is_anomaly_enabled()
        try:
            torch.sqrt(torch.tensor([-1.0]))
        except FloatingPointError as e:
            print(e)
            sys.exit(0)
        sys.exit(1)
    """)
    env = dict(os.environ, MSHA_NAN_GUARD="1")
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "aten.sqrt" in proc.stdout


def test_the_cli_turns_the_guard_on_from_the_environment(tmp_path):
    """``cli.main`` calls ``nan_guard_from_env`` first, as the JAX CLI
    does: a run with ``MSHA_NAN_GUARD`` set has the guard on."""
    script = textwrap.dedent("""
        import sys
        from msha_gnn_torch import cli
        from msha_gnn_torch.utils import debug
        try:
            cli.main(["eval", "--device", "cpu"])   # exits 2: no checkpoint
        finally:
            print(debug._active)
    """)
    env = dict(os.environ, MSHA_NAN_GUARD="1")
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "1"


def test_the_environment_guard_is_turned_on_once(tmp_path):
    """Two ``cli.main`` calls in one process with ``MSHA_NAN_GUARD`` set
    leave one guard on: one count, one mode on the dispatch stack, and a
    NaN still raises."""
    script = textwrap.dedent("""
        import torch
        from torch.utils._python_dispatch import (
            _get_current_dispatch_mode_stack)
        from msha_gnn_torch import cli
        from msha_gnn_torch.utils import debug
        for _ in range(2):
            cli.main(["eval", "--device", "cpu"])   # exits 2: no checkpoint
        modes = [m for m in _get_current_dispatch_mode_stack()
                 if isinstance(m, debug.NanCheckMode)]
        try:
            torch.log(torch.tensor([-1.0]))
            raised = False
        except FloatingPointError:
            raised = True
        print(debug._active, len(modes), raised)
    """)
    env = dict(os.environ, MSHA_NAN_GUARD="1")
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "1 1 True"
