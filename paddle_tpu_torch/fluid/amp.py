"""Automatic mixed precision: bf16 on the tensor cores.

Parity: the JAX package's fluid/amp.py (decorate_program, amp_guard,
is_amp). bf16 has fp32's exponent range, so no loss scaling is needed:
under AMP the matmul, conv and attention rules cast their fp32 operands to
bf16 (lowering.amp_cast) and accumulate in fp32; master weights, optimizer
state and batch-norm statistics stay fp32. AMP is a program flag, read by
Executor._prepare into the step artifact's key and its lowering Ctx, so
one program run with and without AMP builds (and captures) two steps.

Usage:
    fluid.amp.decorate_program(main_program)      # before Executor.run
or  with fluid.amp.amp_guard(): exe.run(...)
"""
import contextlib

from .framework import default_main_program

__all__ = ['decorate_program', 'amp_guard', 'is_amp']

_global_amp = False


def decorate_program(program=None, enable=True):
    if program is None:
        program = default_main_program()
    program._amp = bool(enable)
    program._bump_version()
    return program


@contextlib.contextmanager
def amp_guard(enable=True):
    global _global_amp
    prev = _global_amp
    _global_amp = enable
    try:
        yield
    finally:
        _global_amp = prev


def is_amp(program=None):
    if _global_amp:
        return True
    return bool(getattr(program, '_amp', False)) if program is not None \
        else False
