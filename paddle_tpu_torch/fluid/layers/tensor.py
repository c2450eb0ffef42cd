"""Tensor-creation layers. Parity: reference layers/tensor.py."""
import numpy as np

from ..framework import Variable
from ..layer_helper import LayerHelper
from ..core import convert_dtype

__all__ = ['cast', 'assign']


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

