"""Elementwise / activation / reduction / matmul rules.

Parity: the JAX package's fluid/ops_impl/math_ops.py (reference
paddle/fluid/operators/{elementwise_*,activation,reduce_*,mul,clip,scale}
_op.*). The plain products stay torch.matmul (under AMP cuBLAS's bf16
GEMM with an fp32 result): the JAX package leaves them to XLA outside any
kernel.
"""
import numpy as np
import torch

from ..lowering import register, data_of, like, amp_cast


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


class _Bf16Product(torch.autograd.Function):
    """x @ y of bf16 operands with an fp32 result on the card: cuBLAS's
    bf16 GEMM with fp32 accumulation, its output never rounded to bf16
    (torch.matmul of two bf16 tensors would round it). torch.mm / bmm with
    out_dtype have no autograd formula, so the backward is written here.
    The JAX rule's gradient (and the CPU's exact form) multiplies the fp32
    cotangent by the other bf16 operand in fp32, then rounds to the
    operand's dtype. The bf16 GEMM takes the cotangent as two bf16 terms,
    hi = bf16(g) and lo = bf16(g - hi), each multiplied with an fp32
    result and the two summed: hi + lo keeps g to 2^-17 relative, far
    below the bf16 rounding of the gradient (2^-9) that both apply, so the
    gradient is the reference's but for a rare rounding flip (the split
    of the flash-attention kernels' P and dS)."""

    @staticmethod
    def forward(ctx, x, y):
        ctx.save_for_backward(x, y)
        return _bf16_mm(x, y)

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        hi = g.to(torch.bfloat16)
        lo = (g - hi.to(g.dtype)).to(torch.bfloat16)
        dx = dy = None
        if ctx.needs_input_grad[0]:
            yt = y.transpose(-1, -2)
            dx = (_bf16_mm(hi, yt) + _bf16_mm(lo, yt)).to(x.dtype)
        if ctx.needs_input_grad[1]:
            xt = x.transpose(-1, -2)
            dy = _bf16_mm(xt, hi) + _bf16_mm(xt, lo)
            # y broadcast over the batch: its gradient summed in fp32, then
            # rounded once, as the CPU's exact form
            dy = dy.sum_to_size(y.shape).to(y.dtype)
        return dx, dy


def _bf16_mm(x, y):
    """fp32 x @ y of bf16 tensors on the card (2-D, or batched with y
    broadcast)."""
    if x.dim() == 2 and y.dim() == 2:
        return torch.mm(x, y, out_dtype=torch.float32)
    batch = torch.broadcast_shapes(x.shape[:-2], y.shape[:-2])
    xb = x.expand(batch + x.shape[-2:]).reshape((-1,) + x.shape[-2:])
    yb = y.expand(batch + y.shape[-2:]).reshape((-1,) + y.shape[-2:])
    out = torch.bmm(xb, yb, out_dtype=torch.float32)
    return out.reshape(batch + out.shape[-2:])


def _product(x, y, ctx):
    """x @ y as the JAX rules take it: under AMP the fp32 operands go to
    bf16 (amp_cast) and the product comes back in fp32
    (preferred_element_type=float32), before the rule casts it to the
    input's dtype. On the card that is _Bf16Product (cuBLAS, fp32 result);
    on the CPU and in shape inference the exact form: the bf16 operands
    widened and multiplied in fp32, as XLA's CPU dot computes the bf16
    product (a product of two bf16 values is exact in fp32)."""
    x, y = amp_cast(ctx, x, y)
    if x.dtype != torch.bfloat16 or y.dtype != torch.bfloat16:
        # mixed dtypes promote as jnp.matmul promotes them (bf16 with
        # fp32 is fp32); torch.matmul would refuse them
        dt = torch.promote_types(x.dtype, y.dtype)
        return torch.matmul(x.to(dt), y.to(dt))
    if x.is_cuda:
        return _Bf16Product.apply(x, y)
    return torch.matmul(x.to(torch.float32), y.to(torch.float32))


@register('mul')
def _mul(ins, attrs, ctx):
    """reference operators/mul_op.cc: flatten x to 2-D at x_num_col_dims and
    y at y_num_col_dims, then matmul; the result in x's dtype (the JAX
    :125-144)."""
    x = data_of(ins['X'][0])
    y = data_of(ins['Y'][0])
    xn = attrs.get('x_num_col_dims', 1)
    yn = attrs.get('y_num_col_dims', 1)
    xs, ys = tuple(x.shape), tuple(y.shape)
    x2 = x.reshape(int(np.prod(xs[:xn])), int(np.prod(xs[xn:])))
    y2 = y.reshape(int(np.prod(ys[:yn])), int(np.prod(ys[yn:])))
    out = _product(x2, y2, ctx).to(x.dtype).reshape(xs[:xn] + ys[yn:])
    return {'Out': like(ins['X'][0], out)}


@register('matmul')
def _matmul(ins, attrs, ctx):
    """reference operators/matmul_op.cc: batched x @ y with optional
    transposes of the last two dims, times alpha; the result in x's dtype
    (the JAX :147-160)."""
    x = data_of(ins['X'][0])
    y = data_of(ins['Y'][0])
    if attrs.get('transpose_X', False):
        x = x.transpose(-1, -2)
    if attrs.get('transpose_Y', False):
        y = y.transpose(-1, -2)
    out = _product(x, y, ctx).to(x.dtype) * attrs.get('alpha', 1.0)
    return {'Out': out}


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
