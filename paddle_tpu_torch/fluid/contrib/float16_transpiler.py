"""Half-precision inference transpiler.

Parity: the JAX package's fluid/contrib/float16_transpiler.py (reference
paddle/contrib/float16/float16_transpiler.py). The half dtype is bfloat16
(fp32's exponent range: no scaling concerns; the tensor cores' bf16 rate),
and the op rules take any float dtype, so no op is rewritten. transpile():

1. casts every floating persistable of the program in the scope to bf16
   (half the weight bytes),
2. patches the matching var dtypes in the program,
3. turns the program's AMP on (fluid.amp.decorate_program), so fp32
   inputs (feeds) are cast at the matmul / conv / attention boundaries,
4. sets the program's `_fetch_f32`, so its bf16 fetches come back as
   float32 (the reference's fetch-side cast ops): users keep feeding and
   fetching float32.
"""
import torch

from .. import amp
from ..executor import global_scope
from ..framework import Program

__all__ = ['Float16Transpiler', 'BF16Transpiler']


class Float16Transpiler(object):
    #: the half dtype; the name Float16 is the reference's
    target_dtype = 'bfloat16'

    def transpile(self, program, place=None, scope=None):
        """Convert an inference program and its scope's weights to bf16 in
        place; returns the names converted. `place` is accepted for the
        reference's signature (the tensors stay where they are)."""
        if not isinstance(program, Program):
            raise TypeError('program should be a Program, got %r'
                            % type(program))
        scope = scope if scope is not None else global_scope()
        converted = []
        params = {v.name: v for v in program.list_vars()
                  if v.persistable and str(v.dtype) in
                  ('float32', 'float64')}
        for name, var in params.items():
            val = scope._chain_get(name)
            if isinstance(val, torch.Tensor) and val.is_floating_point():
                scope._chain_set(name, val.detach().to(torch.bfloat16))
                var.dtype = 'bfloat16'
                converted.append(name)
        amp.decorate_program(program)      # cast feeds at the products
        program._fetch_f32 = True          # fetch-side cast back to fp32
        program._bump_version()
        return converted


BF16Transpiler = Float16Transpiler
