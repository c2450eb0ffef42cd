"""Elementwise / activation / comparison / reduction / matmul rules.

Parity: the JAX package's fluid/ops_impl/math_ops.py (reference
paddle/fluid/operators/{elementwise_*,activation,reduce_*,mul,clip,scale,
compare,logical,clip_by_norm,maxout,cos_sim,norm}_op.*). The plain
products stay torch.matmul (under AMP cuBLAS's bf16 GEMM with an fp32
result): the JAX package leaves them to XLA outside any kernel.

Ties take JAX's gradients: a max or min of two operands is torch.maximum
or torch.minimum, which split a tie's gradient 0.5 / 0.5 as lax.max and
lax.min do (torch.relu and torch.clamp give it to one side), a clip is the
minimum of a maximum as jnp.clip is, |x| is where(x >= 0, x, -x) with
jnp.abs's gradient of 1 at 0 (torch.abs has 0 there), and the reductions'
max and min are torch.amax and amin, which share a tie's gradient evenly as
jnp.max does. A scalar bound is a 0-d CPU tensor of x's dtype, so a bf16 x
stays bf16 and no copy to the card is made.

A sequence (SeqValue) operand keeps its lengths through the elementwise
rules (like, first_seq), and the reductions that cross its time axis, and
`mean`, read its valid steps only (the JAX :15-20, :175-227).
"""
import numpy as np
import torch

from ..lowering import SeqValue, register, data_of, like, first_seq, \
    amp_cast


def _seq_pad_mask(v):
    """Broadcastable [batch, max_len, 1...] float32 validity mask of a
    SeqValue."""
    m = v.mask()
    while m.ndim < v.data.ndim:
        m = m[..., None]
    return m


def _scalar(x, v):
    """v as a 0-d CPU tensor of x's dtype: a weak operand on any device."""
    return torch.tensor(v, dtype=x.dtype)


def _abs(x):
    return torch.where(x >= 0, x, -x)


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, _scalar(x, lo)), _scalar(x, hi))


def _unary(op_type, fn):
    @register(op_type)
    def rule(ins, attrs, ctx, _fn=fn):
        x = ins['X'][0]
        return {'Out': like(x, _fn(data_of(x), attrs))}
    return rule


def _elu(x, a):
    # the untaken branch on min(x, 0): jnp.where's gradient is NaN where
    # exp(x) overflows (x > 88), this one is not (ROADMAP.md Queue C)
    neg = torch.exp(torch.minimum(x, _scalar(x, 0))) - 1
    return torch.where(x >= 0, x, a.get('alpha', 1.0) * neg)


_unary('relu', lambda x, a: torch.maximum(x, _scalar(x, 0)))
_unary('sigmoid', lambda x, a: torch.sigmoid(x))
_unary('logsigmoid', lambda x, a: torch.nn.functional.logsigmoid(x))
_unary('exp', lambda x, a: torch.exp(x))
_unary('tanh', lambda x, a: torch.tanh(x))
_unary('tanh_shrink', lambda x, a: x - torch.tanh(x))
_unary('softshrink', lambda x, a: torch.sign(x) * torch.maximum(
    _abs(x) - a.get('lambda', 0.5), _scalar(x, 0)))
_unary('sqrt', lambda x, a: torch.sqrt(x))
_unary('abs', lambda x, a: _abs(x))
_unary('ceil', lambda x, a: torch.ceil(x))
_unary('floor', lambda x, a: torch.floor(x))
_unary('cos', lambda x, a: torch.cos(x))
_unary('sin', lambda x, a: torch.sin(x))
_unary('round', lambda x, a: torch.round(x))
_unary('reciprocal', lambda x, a: 1.0 / x)
_unary('square', lambda x, a: torch.square(x))
# logaddexp's CUDA kernel takes no CPU scalar operand: a zero tensor
_unary('softplus', lambda x, a: torch.logaddexp(x, torch.zeros_like(x)))
_unary('softsign', lambda x, a: x / (1 + _abs(x)))
_unary('brelu', lambda x, a: _clip(x, a.get('t_min', 0.0),
                                   a.get('t_max', 24.0)))
_unary('leaky_relu', lambda x, a: torch.where(x >= 0, x,
                                              a.get('alpha', 0.02) * x))
_unary('soft_relu', lambda x, a: torch.log1p(torch.exp(_clip(
    x, -a.get('threshold', 40.0), a.get('threshold', 40.0)))))
_unary('elu', _elu)
_unary('relu6', lambda x, a: _clip(x, 0.0, a.get('threshold', 6.0)))
_unary('pow', lambda x, a: torch.pow(x, a.get('factor', 1.0)))
_unary('stanh', lambda x, a: a.get('scale_b', 1.7159) * torch.tanh(
    a.get('scale_a', 2.0 / 3.0) * x))
_unary('hard_sigmoid', lambda x, a: _clip(
    a.get('slope', 0.2) * x + a.get('offset', 0.5), 0.0, 1.0))
_unary('swish', lambda x, a: x * torch.sigmoid(a.get('beta', 1.0) * x))
_unary('hard_shrink', lambda x, a: torch.where(
    _abs(x) > a.get('threshold', 0.5), x, 0.0))
_unary('thresholded_relu', lambda x, a: torch.where(
    x > a.get('threshold', 1.0), x, 0.0))
_unary('log', lambda x, a: torch.log(x))
_unary('logical_not', lambda x, a: torch.logical_not(x))
_unary('sign', lambda x, a: torch.sign(x))
_unary('clip', lambda x, a: _clip(x, a['min'], a['max']))
_unary('scale', lambda x, a: (x + a.get('bias', 0.0)) * a['scale']
       if a.get('bias_after_scale', True) is False
       else x * a['scale'] + a.get('bias', 0.0))


@register('clip_by_norm')
def _clip_by_norm(ins, attrs, ctx):
    x = data_of(ins['X'][0])
    max_norm = attrs['max_norm']
    norm = torch.sqrt(torch.sum(torch.square(x)))
    scale = torch.where(norm > max_norm,
                        max_norm / torch.maximum(norm, _scalar(norm, 1e-12)),
                        1.0)
    return {'Out': like(ins['X'][0], x * scale)}


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
        xv, yv = ins['X'][0], ins['Y'][0]
        x, y = data_of(xv), data_of(yv)
        out = _fn(x, _broadcast_y(x, y, attrs.get('axis', -1)))
        return {'Out': like(first_seq(xv, yv), out)}
    return rule


_binary('elementwise_add', torch.add)
_binary('elementwise_sub', torch.sub)
_binary('elementwise_mul', torch.mul)
_binary('elementwise_div', torch.div)
_binary('elementwise_max', torch.maximum)
_binary('elementwise_min', torch.minimum)
_binary('elementwise_pow', torch.pow)
_binary('logical_and', torch.logical_and)
_binary('logical_or', torch.logical_or)
_binary('logical_xor', torch.logical_xor)
_binary('less_than', torch.lt)
_binary('less_equal', torch.le)
_binary('greater_than', torch.gt)
_binary('greater_equal', torch.ge)
_binary('equal', torch.eq)
_binary('not_equal', torch.ne)


@register('sum')
def _sum(ins, attrs, ctx):
    xs = [data_of(v) for v in ins['X']]
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return {'Out': like(first_seq(*ins['X']), out)}


@register('mean')
def _mean(ins, attrs, ctx):
    """Shape [1], not 0-d: reference mean_op's output dims are {1}
    (mean_op.cc InferShape). Over a SeqValue, the mean of its valid steps
    only (the reference's flat LoDTensor has no pad rows)."""
    xv = ins['X'][0]
    x = data_of(xv)
    if isinstance(xv, SeqValue):
        mask = _seq_pad_mask(xv).expand(x.shape)
        return {'Out': (torch.sum(x * mask) / torch.clamp_min(
            torch.sum(mask), 1)).reshape(1)}
    return {'Out': torch.mean(x).reshape(1)}


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


class _Prod(torch.autograd.Function):
    """torch.prod over one dim with a backward that never syncs: torch's
    own counts the zeros on the host (`.item()`), which a captured step
    cannot do. The gradient of each factor is the product of the others,
    the exclusive running products from the left and from the right
    multiplied, exact with zeros among the factors."""

    @staticmethod
    def forward(ctx, x, dim, keepdim):
        ctx.save_for_backward(x)
        ctx.dim, ctx.keepdim = dim, keepdim
        return torch.prod(x, dim=dim, keepdim=keepdim)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        d, n = ctx.dim, x.shape[ctx.dim]
        if not ctx.keepdim:
            g = g.unsqueeze(d)
        one = torch.ones_like(x.narrow(d, 0, 1))
        left = torch.cat([one, x.narrow(d, 0, n - 1)], d).cumprod(d)
        right = torch.cat([x.narrow(d, 1, n - 1), one], d).flip(d) \
            .cumprod(d).flip(d)
        return g * left * right, None, None


def _prod(x, dim, keepdim):
    # one dim at a time, the last first
    for d in sorted((d % x.ndim for d in dim), reverse=True):
        x = _Prod.apply(x, d, keepdim)
    return x


def _reduce_pad_fill(op_type, x):
    """The value a pad step takes in a reduction across the time axis: the
    operation's identity (the JAX :163-172), as a 0-d CPU tensor."""
    if op_type in ('reduce_sum', 'reduce_mean'):
        return _scalar(x, 0)
    if op_type == 'reduce_prod':
        return _scalar(x, 1)
    lim = torch.finfo(x.dtype) if x.is_floating_point() \
        else torch.iinfo(x.dtype)
    return _scalar(x, lim.min if op_type == 'reduce_max' else lim.max)


def _reduce(op_type, fn):
    @register(op_type)
    def rule(ins, attrs, ctx, _fn=fn, _op=op_type):
        xv = ins['X'][0]
        x = data_of(xv)
        dim = attrs.get('dim')
        if attrs.get('reduce_all', False) or dim is None:
            dims = tuple(range(x.ndim))
        else:
            dims = tuple(dim) if isinstance(dim, (list, tuple)) else (dim,)
        keep = bool(attrs.get('keep_dim', False))
        # a reduction across the time axis (axis 1 of [B, T, ...]) reads
        # the valid steps only; one over other axes keeps the sequence,
        # where pads stay pads
        reduces_time = any(d % x.ndim == 1 for d in dims) if x.ndim > 1 \
            else False
        if isinstance(xv, SeqValue) and reduces_time:
            mask = _seq_pad_mask(xv)
            x = torch.where(mask > 0, x, _reduce_pad_fill(_op, x))
            if _op == 'reduce_mean':
                n = torch.sum(mask.expand(x.shape).to(x.dtype), dim=dims,
                              keepdim=keep)
                return {'Out': torch.sum(x, dim=dims, keepdim=keep)
                        / torch.clamp_min(n, 1)}
        out = _fn(x, dims, keep)
        if isinstance(xv, SeqValue) and not reduces_time \
                and out.ndim >= 2 and out.shape[:2] == x.shape[:2]:
            return {'Out': like(xv, out)}
        return {'Out': out}
    return rule


_reduce('reduce_sum', lambda x, d, k: torch.sum(x, dim=d, keepdim=k))
# jnp.mean of an integer tensor is float32
_reduce('reduce_mean', lambda x, d, k: torch.mean(
    x if x.is_floating_point() else x.to(torch.float32), dim=d, keepdim=k))
_reduce('reduce_max', lambda x, d, k: torch.amax(x, dim=d, keepdim=k))
_reduce('reduce_min', lambda x, d, k: torch.amin(x, dim=d, keepdim=k))
_reduce('reduce_prod', _prod)


@register('maxout')
def _maxout(ins, attrs, ctx):
    x = data_of(ins['X'][0])  # NCHW
    g = attrs['groups']
    n, c, h, w = x.shape
    return {'Out': torch.amax(x.reshape(n, c // g, g, h, w), dim=2)}


@register('cos_sim')
def _cos_sim(ins, attrs, ctx):
    x = data_of(ins['X'][0])
    y = data_of(ins['Y'][0])
    xn = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    yn = torch.sqrt(torch.sum(y * y, dim=-1, keepdim=True))
    xy = xn * yn
    out = torch.sum(x * y, dim=-1, keepdim=True) \
        / torch.maximum(xy, _scalar(xy, 1e-12))
    return {'Out': out, 'XNorm': xn, 'YNorm': yn}


@register('l2_normalize')
def _l2_normalize(ins, attrs, ctx):
    x = data_of(ins['X'][0])
    norm = torch.sqrt(torch.sum(x * x, dim=attrs.get('axis', -1),
                                keepdim=True))
    norm = torch.maximum(norm, _scalar(norm, attrs.get('epsilon', 1e-12)))
    return {'Out': like(ins['X'][0], x / norm), 'Norm': norm}
