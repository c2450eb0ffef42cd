"""Tensor-creation layers. Parity: reference layers/tensor.py."""
import numpy as np

from ..framework import Variable
from ..layer_helper import LayerHelper
from ..initializer import Constant
from ..core import convert_dtype

__all__ = [
    'create_tensor', 'create_parameter', 'create_global_var', 'cast',
    'concat', 'sums', 'assign', 'fill_constant_batch_size_like',
    'fill_constant', 'argmin', 'argmax', 'argsort', 'ones', 'zeros',
    'reverse',
]


def create_tensor(dtype, name=None, persistable=False):
    helper = LayerHelper("create_tensor", name=name)
    return helper.create_variable(name=helper.name, dtype=dtype,
                                  persistable=persistable)


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    from ..param_attr import ParamAttr
    helper = LayerHelper("create_parameter", **locals())
    if attr is None:
        attr = ParamAttr(name=name)
    return helper.create_parameter(attr, shape, dtype, is_bias,
                                   default_initializer)


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


def concat(input, axis=0, name=None):
    helper = LayerHelper('concat', **locals())
    # static out shape (reference concat_op InferShape): inputs' shape
    # with the concat axis summed — downstream fc reads .shape
    shape = None
    shapes = [getattr(v, 'shape', None) for v in input]
    if all(s is not None for s in shapes):
        shape = list(shapes[0])
        ax = axis if axis >= 0 else len(shape) + axis
        if all(len(s) == len(shape) for s in shapes) \
                and all(s[ax] is not None and s[ax] >= 0 for s in shapes):
            shape[ax] = sum(s[ax] for s in shapes)
        else:
            shape = None
    out = helper.create_variable_for_type_inference(
        dtype=helper.input_dtype(), shape=shape,
        lod_level=max((getattr(v, 'lod_level', 0) or 0) for v in input))
    helper.append_op(type='concat', inputs={'X': input},
                     outputs={'Out': [out]}, attrs={'axis': axis})
    return out


def sums(input, out=None):
    helper = LayerHelper('sum', **locals())
    if out is None:
        out = helper.create_variable_for_type_inference(
            dtype=helper.input_dtype())
    helper.append_op(type='sum', inputs={'X': input}, outputs={'Out': out})
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


def fill_constant_batch_size_like(input, shape, dtype, value,
                                  input_dim_idx=0, output_dim_idx=0):
    helper = LayerHelper("fill_constant_batch_size_like", **locals())
    out = helper.create_variable_for_type_inference(
        dtype=convert_dtype(dtype))
    helper.append_op(type='fill_constant_batch_size_like',
                     inputs={'Input': [input]}, outputs={'Out': [out]},
                     attrs={'shape': list(shape),
                            'dtype': convert_dtype(dtype),
                            'value': float(value),
                            'input_dim_idx': input_dim_idx,
                            'output_dim_idx': output_dim_idx})
    out.stop_gradient = True
    return out


def ones(shape, dtype, force_cpu=False):
    return fill_constant(value=1.0, shape=shape, dtype=dtype)


def zeros(shape, dtype, force_cpu=False):
    return fill_constant(value=0.0, shape=shape, dtype=dtype)


def argmin(x, axis=0):
    helper = LayerHelper("arg_min", **locals())
    out = helper.create_variable_for_type_inference('int64')
    helper.append_op(type='arg_min', inputs={'X': x}, outputs={'Out': [out]},
                     attrs={'axis': axis})
    return out


def argmax(x, axis=0):
    helper = LayerHelper("arg_max", **locals())
    out = helper.create_variable_for_type_inference('int64')
    helper.append_op(type='arg_max', inputs={'X': x}, outputs={'Out': [out]},
                     attrs={'axis': axis})
    return out


def argsort(input, axis=-1, name=None):
    helper = LayerHelper("argsort", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    ids = helper.create_variable_for_type_inference('int64')
    helper.append_op(type='argsort', inputs={'X': input},
                     outputs={'Out': out, 'Indices': ids},
                     attrs={'axis': axis})
    return out, ids


def reverse(x, axis):
    helper = LayerHelper("reverse", **locals())
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type='reverse', inputs={'X': x}, outputs={'Out': [out]},
                     attrs={'axis': axis})
    return out
