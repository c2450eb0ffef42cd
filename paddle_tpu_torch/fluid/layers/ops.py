"""Elementwise / scale / clip layers. Parity: reference layers/ops.py."""
from ..layer_helper import LayerHelper

__all__ = ['mul', 'scale', 'clip', 'elementwise_add', 'elementwise_sub',
           'elementwise_mul', 'elementwise_div', 'elementwise_min']


def _single_in_op(op_type, x, attrs=None, name=None):
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type=op_type, inputs={'X': [x]}, outputs={'Out': [out]},
                     attrs=attrs or {})
    return out


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    helper = LayerHelper('mul', name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type='mul', inputs={'X': [x], 'Y': [y]},
                     outputs={'Out': [out]},
                     attrs={'x_num_col_dims': x_num_col_dims,
                            'y_num_col_dims': y_num_col_dims})
    return out


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    helper = LayerHelper('scale', name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type='scale', inputs={'X': [x]}, outputs={'Out': [out]},
                     attrs={'scale': float(scale), 'bias': float(bias),
                            'bias_after_scale': bias_after_scale})
    if act is None:
        return out
    helper.kwargs['act'] = act
    return helper.append_activation(out)


def clip(x, min, max, name=None):
    return _single_in_op('clip', x, attrs={'min': float(min), 'max': float(max)},
                         name=name)


def _make_binary(op_type):
    def layer(x, y, axis=-1, act=None, name=None):
        helper = LayerHelper(op_type, name=name, act=act)
        out = helper.create_variable_for_type_inference(x.dtype)
        helper.append_op(type=op_type, inputs={'X': [x], 'Y': [y]},
                         outputs={'Out': [out]}, attrs={'axis': axis})
        return helper.append_activation(out)
    layer.__name__ = op_type
    return layer


elementwise_add = _make_binary('elementwise_add')
elementwise_sub = _make_binary('elementwise_sub')
elementwise_mul = _make_binary('elementwise_mul')
elementwise_div = _make_binary('elementwise_div')
elementwise_min = _make_binary('elementwise_min')
