"""Tensor creation / manipulation rules.

Parity: the JAX package's fluid/ops_impl/tensor_ops.py (reference
paddle/fluid/operators/{fill_constant,cast,reshape,transpose,one_hot,
assign_value,uniform_random,gaussian_random,label_smooth}_op.*). Random ops
draw from the Executor's torch.Generator, so they give other numbers than
jax.random from the same seed, with the same distribution.
"""
import numpy as np
import torch

from ..core import torch_dtype
from ..lowering import register, data_of, like


@register('fill_constant', constant=True)
def _fill_constant(ins, attrs, ctx):
    return {'Out': torch.full(tuple(attrs['shape']), attrs['value'],
                              dtype=torch_dtype(attrs.get('dtype', 'float32')),
                              device=ctx.device)}


@register('uniform_random')
def _uniform_random(ins, attrs, ctx):
    out = torch.empty(tuple(attrs['shape']), dtype=torch.float32,
                      device=ctx.device)
    out.uniform_(attrs.get('min', -1.0), attrs.get('max', 1.0),
                 generator=ctx.generator)
    return {'Out': out.to(torch_dtype(attrs.get('dtype', 'float32')))}


@register('gaussian_random')
def _gaussian_random(ins, attrs, ctx):
    out = torch.empty(tuple(attrs['shape']), dtype=torch.float32,
                      device=ctx.device)
    out.normal_(attrs.get('mean', 0.0), attrs.get('std', 1.0),
                generator=ctx.generator)
    return {'Out': out.to(torch_dtype(attrs.get('dtype', 'float32')))}


@register('assign_value', constant=True)
def _assign_value(ins, attrs, ctx):
    vals = np.asarray(attrs['values'],
                      dtype=attrs.get('dtype', 'float32')).reshape(
                          attrs['shape'])
    return {'Out': torch.from_numpy(vals).to(ctx.device)}


@register('cast')
def _cast(ins, attrs, ctx):
    x = ins['X'][0]
    return {'Out': like(x, data_of(x).to(torch_dtype(attrs['out_dtype'])))}


@register('increment')
def _increment(ins, attrs, ctx):
    x = data_of(ins['X'][0])
    # the step in x's dtype, as a 0-dim CPU tensor: a scalar operand on any
    # device, with no host-to-device copy
    return {'Out': x + torch.tensor(attrs.get('step', 1.0), dtype=x.dtype)}


@register('assign')
def _assign(ins, attrs, ctx):
    return {'Out': ins['X'][0]}


@register('reshape')
def _reshape(ins, attrs, ctx):
    x = data_of(ins['X'][0])
    # Fluid semantics (operators/reshape_op.cc): 0 means "copy input dim",
    # one -1 is inferred
    out_shape = [x.shape[i] if int(d) == 0 else int(d)
                 for i, d in enumerate(attrs['shape'])]
    return {'Out': x.reshape(out_shape)}


@register('transpose')
def _transpose(ins, attrs, ctx):
    return {'Out': data_of(ins['X'][0]).permute(*attrs['axis'])}


@register('one_hot')
def _one_hot(ins, attrs, ctx):
    x = data_of(ins['X'][0])
    if x.ndim >= 2 and x.shape[-1] == 1:
        x = x.squeeze(-1)
    # comparison, not F.one_hot: an out-of-range id (e.g. -1) gives an
    # all-zero row, as jax.nn.one_hot does, instead of raising
    classes = torch.arange(attrs['depth'], device=x.device)
    out = (x.long().unsqueeze(-1) == classes).to(torch.float32)
    return {'Out': like(ins['X'][0], out)}


@register('label_smooth')
def _label_smooth(ins, attrs, ctx):
    x = data_of(ins['X'][0])
    eps = attrs.get('epsilon', 0.0)
    if ins.get('PriorDist'):
        out = (1 - eps) * x + eps * data_of(ins['PriorDist'][0])
    else:
        out = (1 - eps) * x + eps / x.shape[-1]
    return {'Out': like(ins['X'][0], out)}
