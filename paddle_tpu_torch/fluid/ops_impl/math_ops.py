"""Elementwise / activation / reduction / matmul rules.

Parity: the JAX package's fluid/ops_impl/math_ops.py (reference
paddle/fluid/operators/{elementwise_*,activation,reduce_*,mul,clip,scale}
_op.*). The plain products stay torch.matmul: the JAX package leaves them
to XLA outside any kernel.
"""
import numpy as np
import torch

from ..lowering import register, data_of, like


def _unary(op_type, fn):
    @register(op_type)
    def rule(ins, attrs, ctx, _fn=fn):
        x = ins['X'][0]
        return {'Out': like(x, _fn(data_of(x), attrs))}
    return rule


_unary('relu', lambda x, a: torch.relu(x))
_unary('sigmoid', lambda x, a: torch.sigmoid(x))
_unary('sqrt', lambda x, a: torch.sqrt(x))
_unary('square', lambda x, a: torch.square(x))
_unary('sign', lambda x, a: torch.sign(x))
_unary('clip', lambda x, a: torch.clamp(x, a['min'], a['max']))
_unary('scale', lambda x, a: (x + a.get('bias', 0.0)) * a['scale']
       if a.get('bias_after_scale', True) is False
       else x * a['scale'] + a.get('bias', 0.0))


def _broadcast_y(x, y, axis):
    """Fluid elementwise broadcast: align y's dims to x starting at `axis`
    (reference operators/elementwise_op_function.h)."""
    if x.ndim <= y.ndim:
        # same rank, or x is lower-rank: plain broadcasting applies
        return y
    if axis == -1:
        axis = x.ndim - y.ndim
    shape = [1] * x.ndim
    for i, d in enumerate(y.shape):
        shape[axis + i] = d
    return y.reshape(shape)


def _binary(op_type, fn):
    @register(op_type)
    def rule(ins, attrs, ctx, _fn=fn):
        x, y = data_of(ins['X'][0]), data_of(ins['Y'][0])
        return {'Out': _fn(x, _broadcast_y(x, y, attrs.get('axis', -1)))}
    return rule


_binary('elementwise_add', torch.add)
_binary('elementwise_sub', torch.sub)
_binary('elementwise_mul', torch.mul)
_binary('elementwise_div', torch.div)
_binary('elementwise_max', torch.maximum)
_binary('elementwise_min', torch.minimum)
_binary('elementwise_pow', torch.pow)


@register('sum')
def _sum(ins, attrs, ctx):
    xs = [data_of(v) for v in ins['X']]
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return {'Out': out}


@register('mean')
def _mean(ins, attrs, ctx):
    # shape [1], not 0-d: reference mean_op's output dims are {1}
    # (mean_op.cc InferShape); the dense form (no sequence values yet)
    return {'Out': torch.mean(data_of(ins['X'][0])).reshape(1)}


@register('mul')
def _mul(ins, attrs, ctx):
    """reference operators/mul_op.cc: flatten x to 2-D at x_num_col_dims and
    y at y_num_col_dims, then matmul."""
    x = data_of(ins['X'][0])
    y = data_of(ins['Y'][0])
    xn = attrs.get('x_num_col_dims', 1)
    yn = attrs.get('y_num_col_dims', 1)
    xs, ys = tuple(x.shape), tuple(y.shape)
    x2 = x.reshape(int(np.prod(xs[:xn])), int(np.prod(xs[xn:])))
    y2 = y.reshape(int(np.prod(ys[:yn])), int(np.prod(ys[yn:])))
    out = torch.matmul(x2, y2).reshape(xs[:xn] + ys[yn:])
    return {'Out': like(ins['X'][0], out)}


@register('reduce_sum')
def _reduce_sum(ins, attrs, ctx):
    x = data_of(ins['X'][0])
    dim = attrs.get('dim')
    if attrs.get('reduce_all', False) or dim is None:
        dims = tuple(range(x.ndim))
    else:
        dims = tuple(dim) if isinstance(dim, (list, tuple)) else (dim,)
    return {'Out': torch.sum(x, dim=dims,
                             keepdim=bool(attrs.get('keep_dim', False)))}
