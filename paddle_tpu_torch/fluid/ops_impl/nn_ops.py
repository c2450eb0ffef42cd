"""Normalization / dropout / loss / attention rules.

Parity: the JAX package's fluid/ops_impl/nn_ops.py (layer_norm :219,
dropout :240, softmax_with_cross_entropy :276,
sigmoid_cross_entropy_with_logits :292, auc :366, flash_attention :529).
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


@register('sigmoid_cross_entropy_with_logits')
def _sigmoid_xent(ins, attrs, ctx):
    x = data_of(ins['X'][0])
    label = data_of(ins['Label'][0])
    # max(x, 0) as torch.maximum: at x == 0 its gradient splits between the
    # two operands, as jnp.maximum's does
    loss = torch.maximum(x, torch.zeros_like(x)) - x * label \
        + torch.log1p(torch.exp(-torch.abs(x)))
    return {'Out': like(ins['X'][0], loss)}


@register('auc')
def _auc(ins, attrs, ctx):
    """Streaming AUC over persistable confusion buckets (reference
    operators/auc_op.cc; the JAX rule nn_ops.py:366-390). The histograms
    stay int64 and the area is summed in float64 on every device; the JAX
    package, with x64 off, carries them as int32 and sums in float32. The
    values agree, the carried stats' dtypes do not."""
    probs = data_of(ins['Predict'][0])
    label = data_of(ins['Label'][0]).reshape(-1)
    stat_pos = data_of(ins['StatPos'][0])
    stat_neg = data_of(ins['StatNeg'][0])
    num_t = stat_pos.shape[0]
    p1 = probs[:, 1] if probs.ndim == 2 and probs.shape[1] >= 2 \
        else probs.reshape(-1)
    # truncation toward zero, as the JAX rule's astype(int32)
    bucket = (p1 * num_t).to(torch.int64).clamp(0, num_t - 1)
    is_pos = (label > 0).to(torch.int64)
    zeros = torch.zeros((num_t,), dtype=torch.int64, device=probs.device)
    new_pos = stat_pos + zeros.index_add(0, bucket, is_pos)
    new_neg = stat_neg + zeros.index_add(0, bucket, 1 - is_pos)
    # AUC = (sum over thresholds of neg_below * pos_at + .5*neg_at*pos_at)
    #       / (P*N)
    pos = new_pos.to(torch.float64)
    neg = new_neg.to(torch.float64)
    tot_pos = torch.cumsum(pos, 0)
    tot_neg = torch.cumsum(neg, 0)
    area = torch.sum((tot_neg - neg * 0.5) * pos)
    denom = torch.clamp_min(tot_pos[-1] * tot_neg[-1], 1.0)
    return {'AUC': (area / denom).to(torch.float32),
            'StatPosOut': new_pos, 'StatNegOut': new_neg}


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
