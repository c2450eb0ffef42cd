"""fluid.contrib of the port: the half-precision inference transpiler.

Parity: the JAX package's fluid/contrib/__init__.py, reduced to
float16_transpiler; memory_usage_calc and the decoder helpers wait for
later slices.
"""
from . import float16_transpiler
from .float16_transpiler import Float16Transpiler, BF16Transpiler

__all__ = ['float16_transpiler', 'Float16Transpiler', 'BF16Transpiler']
