"""Operator overloads on Variable. Parity: reference layers/math_op_patch.py
and the JAX package's fluid/layers/math_op_patch.py: `x + 1.0`,
`2.0 * x`, `x ** y`, `x < y` ... append the same ops as there. A scalar
operand becomes a scale op where one exists, else a fill_constant var."""
from ..framework import Variable
from .. import unique_name

__all__ = ['monkey_patch_variable']


def monkey_patch_variable():
    def unique_tmp_name():
        return unique_name.generate("tmp")

    def create_scalar_var(block, value, dtype, shape=()):
        var = block.create_var(name=unique_tmp_name(), shape=shape,
                               dtype=dtype)
        block.append_op(type="fill_constant", outputs={'Out': [var]},
                        attrs={'dtype': var.dtype, 'shape': list(shape),
                               'value': float(value)}, infer_shape=False)
        var.stop_gradient = True
        return var

    def astype(self, dtype):
        block = self.block
        out = block.create_var(name=unique_tmp_name(), dtype=dtype,
                               shape=None)
        block.append_op(type="cast", inputs={"X": [self]},
                        outputs={"Out": [out]},
                        attrs={"in_dtype": self.dtype,
                               "out_dtype": out.dtype})
        return out

    def _elemwise_method_creator_(method_name, op_type, reverse=False,
                                  scalar_method=None):
        def __impl__(self, other_var):
            block = self.block
            if isinstance(other_var, (int, float)):
                if scalar_method is not None:
                    return scalar_method(self, other_var)
                other_var = create_scalar_var(block, other_var, self.dtype)
            lhs, rhs = self, other_var
            if reverse:
                lhs, rhs = rhs, lhs
            out = block.create_var(name=unique_tmp_name(), dtype=lhs.dtype,
                                   shape=None)
            block.append_op(type=op_type, inputs={'X': [lhs], 'Y': [rhs]},
                            outputs={'Out': [out]}, attrs={'axis': -1})
            return out
        __impl__.__name__ = method_name
        return __impl__

    def _scale_method(op):
        def impl(self, scalar):
            from . import ops
            if op == 'add':
                return ops.scale(self, scale=1.0, bias=float(scalar))
            if op == 'sub':
                return ops.scale(self, scale=1.0, bias=-float(scalar))
            if op == 'rsub':
                return ops.scale(self, scale=-1.0, bias=float(scalar))
            if op == 'mul':
                return ops.scale(self, scale=float(scalar))
            if op == 'div':
                return ops.scale(self, scale=1.0 / float(scalar))
            raise ValueError(op)
        return impl

    Variable.astype = astype
    Variable.__add__ = _elemwise_method_creator_(
        "__add__", "elementwise_add", scalar_method=_scale_method('add'))
    Variable.__radd__ = _elemwise_method_creator_(
        "__radd__", "elementwise_add", scalar_method=_scale_method('add'))
    Variable.__sub__ = _elemwise_method_creator_(
        "__sub__", "elementwise_sub", scalar_method=_scale_method('sub'))
    Variable.__rsub__ = _elemwise_method_creator_(
        "__rsub__", "elementwise_sub", reverse=True,
        scalar_method=_scale_method('rsub'))
    Variable.__mul__ = _elemwise_method_creator_(
        "__mul__", "elementwise_mul", scalar_method=_scale_method('mul'))
    Variable.__rmul__ = _elemwise_method_creator_(
        "__rmul__", "elementwise_mul", scalar_method=_scale_method('mul'))
    Variable.__div__ = _elemwise_method_creator_(
        "__div__", "elementwise_div", scalar_method=_scale_method('div'))
    Variable.__truediv__ = Variable.__div__
    Variable.__rdiv__ = _elemwise_method_creator_(
        "__rdiv__", "elementwise_div", reverse=True)
    Variable.__rtruediv__ = Variable.__rdiv__
    Variable.__pow__ = _elemwise_method_creator_("__pow__", "elementwise_pow")
    Variable.__eq__ = _elemwise_method_creator_("__eq__", "equal")
    Variable.__ne__ = _elemwise_method_creator_("__ne__", "not_equal")
    Variable.__lt__ = _elemwise_method_creator_("__lt__", "less_than")
    Variable.__le__ = _elemwise_method_creator_("__le__", "less_equal")
    Variable.__gt__ = _elemwise_method_creator_("__gt__", "greater_than")
    Variable.__ge__ = _elemwise_method_creator_("__ge__", "greater_equal")
    Variable.__neg__ = lambda self: _scale_method('rsub')(self, 0.0)
    Variable.__hash__ = lambda self: hash(id(self))


monkey_patch_variable()
