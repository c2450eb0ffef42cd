"""Tensor-creation layers. Parity: reference layers/tensor.py."""
import numpy as np

from ..framework import Variable
from ..layer_helper import LayerHelper
from ..initializer import Constant
from ..core import convert_dtype

__all__ = ['create_global_var', 'cast', 'assign', 'fill_constant']


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    """A global-block var filled with `value` by the startup program."""
    helper = LayerHelper("global_var", name=name)
    var = helper.create_global_variable(dtype=dtype, shape=shape,
                                        persistable=persistable,
                                        name=name)
    helper.set_variable_initializer(var,
                                    initializer=Constant(value=float(value)))
    return var


def cast(x, dtype):
    helper = LayerHelper('cast', **locals())
    out = helper.create_variable_for_type_inference(dtype=convert_dtype(dtype))
    helper.append_op(type='cast', inputs={'X': [x]}, outputs={'Out': [out]},
                     attrs={'in_dtype': x.dtype, 'out_dtype': convert_dtype(dtype)})
    return out


def assign(input, output=None):
    helper = LayerHelper('assign', **locals())
    if isinstance(input, Variable):
        if output is None:
            output = helper.create_variable_for_type_inference(dtype=input.dtype)
        helper.append_op(type='assign', inputs={'X': [input]},
                         outputs={'Out': [output]})
    elif isinstance(input, np.ndarray):
        if output is None:
            output = helper.create_variable_for_type_inference(
                dtype=str(input.dtype))
        helper.append_op(type='assign_value', outputs={'Out': [output]},
                         attrs={'shape': list(input.shape),
                                'dtype': str(input.dtype),
                                'values': input.reshape(-1).tolist()})
    else:
        raise ValueError("assign expects Variable or numpy.ndarray")
    return output


def fill_constant(shape, dtype, value, force_cpu=False, out=None):
    helper = LayerHelper("fill_constant", **locals())
    if out is None:
        out = helper.create_variable_for_type_inference(
            dtype=convert_dtype(dtype))
    helper.append_op(type='fill_constant', outputs={'Out': [out]},
                     attrs={'shape': list(shape),
                            'dtype': convert_dtype(dtype),
                            'value': float(value), 'force_cpu': force_cpu})
    out.stop_gradient = True
    return out
