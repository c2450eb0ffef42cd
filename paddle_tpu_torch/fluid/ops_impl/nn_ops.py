"""Normalization / dropout / loss / attention rules.

Parity: the JAX package's fluid/ops_impl/nn_ops.py (layer_norm :219,
dropout :240, softmax_with_cross_entropy :276, flash_attention :529).
"""
import torch

from ... import ops
from ..lowering import register, data_of, like


@register('layer_norm')
def _layer_norm(ins, attrs, ctx):
    x = data_of(ins['X'][0])
    eps = attrs.get('epsilon', 1e-5)
    axis = attrs.get('begin_norm_axis', 1)
    red = tuple(range(axis, x.ndim))
    xf = x.to(torch.float32)
    mean = xf.mean(dim=red, keepdim=True)
    var = (xf - mean).square().mean(dim=red, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    norm_shape = (1,) * axis + tuple(x.shape[axis:])
    if ins.get('Scale'):
        y = y * data_of(ins['Scale'][0]).reshape(norm_shape)
    if ins.get('Bias'):
        y = y + data_of(ins['Bias'][0]).reshape(norm_shape)
    lead = tuple(x.shape[:axis])
    return {'Y': like(ins['X'][0], y.to(x.dtype)),
            'Mean': mean.reshape(lead),
            'Variance': var.reshape(lead)}


@register('dropout')
def _dropout(ins, attrs, ctx):
    x = data_of(ins['X'][0])
    p = attrs.get('dropout_prob', 0.5)
    if attrs.get('is_test', False) or ctx.is_test:
        # downgrade_in_infer (the reference's default): inference scales
        # by the keep probability instead of training rescaling by 1/(1-p)
        return {'Out': like(ins['X'][0], x * (1.0 - p)), 'Mask': None}
    mask = torch.empty_like(x).bernoulli_(1.0 - p, generator=ctx.generator)
    return {'Out': like(ins['X'][0], x * mask), 'Mask': mask}


@register('softmax_with_cross_entropy')
def _softmax_with_cross_entropy(ins, attrs, ctx):
    logits = data_of(ins['Logits'][0])
    label = data_of(ins['Label'][0])
    sm = torch.softmax(logits, dim=-1)
    logp = torch.log_softmax(logits, dim=-1)
    if attrs.get('soft_label', False):
        loss = -(label * logp).sum(dim=-1, keepdim=True)
    else:
        li = label.long()
        if li.ndim == logits.ndim:
            li = li.squeeze(-1)
        loss = -torch.gather(logp, -1, li.unsqueeze(-1))
    return {'Softmax': sm, 'Loss': like(ins['Logits'][0], loss)}


@register('flash_attention')
def _flash_attention(ins, attrs, ctx):
    """Fused attention through ops.flash_attention: the CUDA kernel for
    tensors on the card, its plain torch version on the CPU (and on meta
    tensors during shape inference). The kernel takes contiguous
    [B, H, T, D] operands, so the head-split views are packed here — the
    copy XLA's transpose makes in the JAX package."""
    q = data_of(ins['Q'][0]).contiguous()
    k = data_of(ins['K'][0]).contiguous()
    v = data_of(ins['V'][0]).contiguous()
    kb = ins.get('KeyBias')
    kb = data_of(kb[0]) if kb else None
    if kb is not None:
        kb = kb.reshape(kb.shape[0], kb.shape[-1])
    scale = attrs.get('scale', -1.0)
    scale = None if scale is None or scale < 0 else float(scale)
    out = ops.flash_attention(q, k, v, key_bias=kb,
                              causal=bool(attrs.get('causal', False)),
                              sm_scale=scale)
    return {'Out': out}
