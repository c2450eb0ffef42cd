"""Activation / elementwise / scale / clip / loss layers. Parity:
reference layers/ops.py and the JAX package's fluid/layers/ops.py, whose
activation generator (:5-8, :49) here makes only the activations whose
rules the port has."""
from ..layer_helper import LayerHelper

__activations__ = ['sigmoid', 'sqrt', 'square']

__all__ = __activations__ + [
    'mean', 'mul', 'scale', 'clip', 'sigmoid_cross_entropy_with_logits',
    'elementwise_add', 'elementwise_sub', 'elementwise_mul',
    'elementwise_div', 'elementwise_min']


def _single_in_op(op_type, x, attrs=None, name=None):
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type=op_type, inputs={'X': [x]}, outputs={'Out': [out]},
                     attrs=attrs or {})
    return out


def _make_unary(op_type):
    def layer(x, name=None, **kwargs):
        kwargs.pop('act', None)
        return _single_in_op(op_type, x, attrs=kwargs, name=name)
    layer.__name__ = op_type
    layer.__doc__ = ("%s activation (reference layers/ops.py generated "
                     "from operators/activation_op.cc)" % op_type)
    return layer


for _a in __activations__:
    globals()[_a] = _make_unary(_a)


def mean(x, name=None):
    return _single_in_op('mean', x, name=name)


def sigmoid_cross_entropy_with_logits(x, label, name=None):
    helper = LayerHelper('sigmoid_cross_entropy_with_logits', name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type='sigmoid_cross_entropy_with_logits',
                     inputs={'X': [x], 'Label': [label]},
                     outputs={'Out': [out]})
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
