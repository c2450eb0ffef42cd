"""Activation / elementwise / logical / scale / clip / random layers.
Parity: reference layers/ops.py and the JAX package's fluid/layers/ops.py
(its generated activations, :5-8 and :49, and the hand-written layers;
cumsum waits for the extra_ops rules)."""
from ..layer_helper import LayerHelper

__activations__ = [
    'sigmoid', 'logsigmoid', 'exp', 'tanh', 'tanh_shrink', 'softshrink',
    'sqrt', 'abs', 'ceil', 'floor', 'cos', 'sin', 'round', 'reciprocal',
    'square', 'softplus', 'softsign', 'brelu', 'leaky_relu', 'soft_relu',
    'elu', 'relu6', 'pow', 'stanh', 'hard_sigmoid', 'swish',
]

__all__ = __activations__ + [
    'sign', 'uniform_random', 'hard_shrink', 'thresholded_relu',
    'mean', 'mul', 'scale', 'sigmoid_cross_entropy_with_logits',
    'elementwise_add', 'elementwise_div', 'elementwise_sub',
    'elementwise_mul', 'elementwise_max', 'elementwise_min',
    'elementwise_pow', 'clip', 'clip_by_norm', 'logical_and', 'logical_or',
    'logical_xor', 'logical_not', 'uniform_random_batch_size_like',
    'gaussian_random', 'gaussian_random_batch_size_like', 'sum', 'slice',
    'shape', 'maxout', 'cumsum',
]


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


def sigmoid_cross_entropy_with_logits(x, label, name=None):
    helper = LayerHelper('sigmoid_cross_entropy_with_logits', name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type='sigmoid_cross_entropy_with_logits',
                     inputs={'X': [x], 'Label': [label]},
                     outputs={'Out': [out]})
    return out


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
elementwise_max = _make_binary('elementwise_max')
elementwise_min = _make_binary('elementwise_min')
elementwise_pow = _make_binary('elementwise_pow')


def _make_logical_binary(op_type):
    def layer(x, y, out=None, name=None):
        helper = LayerHelper(op_type, name=name)
        if out is None:
            out = helper.create_variable_for_type_inference('bool')
        helper.append_op(type=op_type, inputs={'X': [x], 'Y': [y]},
                         outputs={'Out': [out]})
        return out
    layer.__name__ = op_type
    return layer


logical_and = _make_logical_binary('logical_and')
logical_or = _make_logical_binary('logical_or')
logical_xor = _make_logical_binary('logical_xor')


def logical_not(x, out=None, name=None):
    helper = LayerHelper('logical_not', name=name)
    if out is None:
        out = helper.create_variable_for_type_inference('bool')
    helper.append_op(type='logical_not', inputs={'X': [x]},
                     outputs={'Out': [out]})
    return out


def clip(x, min, max, name=None):
    return _single_in_op('clip', x, attrs={'min': float(min), 'max': float(max)},
                         name=name)


def clip_by_norm(x, max_norm, name=None):
    return _single_in_op('clip_by_norm', x, attrs={'max_norm': float(max_norm)},
                         name=name)


def uniform_random_batch_size_like(input, shape, dtype='float32',
                                   input_dim_idx=0, output_dim_idx=0,
                                   min=-1.0, max=1.0, seed=0):
    helper = LayerHelper('uniform_random_batch_size_like', **locals())
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type='uniform_random_batch_size_like',
                     inputs={'Input': [input]}, outputs={'Out': [out]},
                     attrs={'shape': list(shape), 'dtype': dtype,
                            'input_dim_idx': input_dim_idx,
                            'output_dim_idx': output_dim_idx,
                            'min': min, 'max': max, 'seed': seed})
    return out


def gaussian_random(shape, dtype='float32', mean=0.0, std=1.0, seed=0):
    helper = LayerHelper('gaussian_random', **locals())
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type='gaussian_random', outputs={'Out': [out]},
                     attrs={'shape': list(shape), 'dtype': dtype,
                            'mean': mean, 'std': std, 'seed': seed})
    return out


def gaussian_random_batch_size_like(input, shape, dtype='float32',
                                    input_dim_idx=0, output_dim_idx=0,
                                    mean=0.0, std=1.0, seed=0):
    helper = LayerHelper('gaussian_random_batch_size_like', **locals())
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type='gaussian_random_batch_size_like',
                     inputs={'Input': [input]}, outputs={'Out': [out]},
                     attrs={'shape': list(shape), 'dtype': dtype,
                            'input_dim_idx': input_dim_idx,
                            'output_dim_idx': output_dim_idx,
                            'mean': mean, 'std': std, 'seed': seed})
    return out


def sum(x):
    from .tensor import sums
    if not isinstance(x, (list, tuple)):
        x = [x]
    return sums(list(x))


def slice(input, axes, starts, ends, name=None):
    helper = LayerHelper('slice', name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type='slice', inputs={'Input': [input]},
                     outputs={'Out': [out]},
                     attrs={'axes': list(axes), 'starts': list(starts),
                            'ends': list(ends)})
    return out


def shape(input, name=None):
    helper = LayerHelper('shape', name=name)
    out = helper.create_variable_for_type_inference('int32')
    helper.append_op(type='shape', inputs={'Input': [input]},
                     outputs={'Out': [out]})
    return out


def maxout(x, groups, name=None):
    return _single_in_op('maxout', x, attrs={'groups': groups}, name=name)


def uniform_random(shape, dtype='float32', min=-1.0, max=1.0, seed=0):
    """Uniform-random tensor of a static shape (reference layers/ops.py:77,
    operators/uniform_random_op.cc), drawn from the Executor's generator;
    `seed` is accepted and not read, as in the JAX package."""
    helper = LayerHelper('uniform_random', **locals())
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type='uniform_random', outputs={'Out': [out]},
                     attrs={'shape': list(shape), 'dtype': dtype,
                            'min': min, 'max': max, 'seed': seed})
    return out


def hard_shrink(x, threshold=None):
    """Hard-shrink: x where |x| > threshold else 0 (reference
    layers/ops.py:97, operators/activation_op.cc HardShrink, default 0.5)."""
    attrs = {} if threshold is None else {'threshold': float(threshold)}
    return _single_in_op('hard_shrink', x, attrs=attrs)


def thresholded_relu(x, threshold=None):
    """Thresholded ReLU: x where x > threshold else 0 (reference
    layers/ops.py:140, operators/activation_op.cc ThresholdedRelu,
    default 1.0)."""
    attrs = {} if threshold is None else {'threshold': float(threshold)}
    return _single_in_op('thresholded_relu', x, attrs=attrs)


def cumsum(x, axis=-1, exclusive=False, reverse=False, name=None):
    """Cumulative sum along axis (the JAX layers/ops.py:244; reference
    operators/cum_op.h)."""
    return _single_in_op('cumsum', x,
                         attrs={'axis': axis, 'exclusive': exclusive,
                                'reverse': reverse}, name=name)


def sign(x, name=None):
    """Elementwise sign (reference operators/sign_op.cc; no v0.14 python
    layer existed — exposed here alongside the generated activations)."""
    return _single_in_op('sign', x, name=name)
