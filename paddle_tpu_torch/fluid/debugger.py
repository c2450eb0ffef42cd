"""Eager NaN/Inf attribution.

Parity: the JAX package's fluid/debugger.py (:17-40) and the reference's
FLAGS_check_nan_inf (paddle/fluid/framework/operator.cc CheckNanInf). While
the check is active, Executor.run takes the artifact's eager walk
(StepArtifact.debug_step) instead of replaying its captured graph, checks
every floating output of every op and raises FloatingPointError naming the
first op whose output holds a NaN or an Inf. The graphviz helpers of the
JAX module wait for a later slice.
"""
import contextlib

__all__ = ['enable_check_nan_inf', 'disable_check_nan_inf',
           'nan_inf_check_active', 'check_nan_inf']

_check_nan_inf = {'active': False}


def enable_check_nan_inf():
    """Run subsequent Executor.run calls op by op, raising
    FloatingPointError naming the first op whose output is NaN/Inf."""
    _check_nan_inf['active'] = True


def disable_check_nan_inf():
    _check_nan_inf['active'] = False


def nan_inf_check_active():
    return _check_nan_inf['active']


@contextlib.contextmanager
def check_nan_inf():
    """Scoped debug mode: with debugger.check_nan_inf(): exe.run(...)"""
    prev = _check_nan_inf['active']
    _check_nan_inf['active'] = True
    try:
        yield
    finally:
        _check_nan_inf['active'] = prev
