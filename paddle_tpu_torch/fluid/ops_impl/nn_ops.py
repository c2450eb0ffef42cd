"""Conv / pool / normalization / dropout / loss / metric / attention rules.

Parity: the JAX package's fluid/ops_impl/nn_ops.py (conv2d :23, pool2d
:157 with _pool :119, batch_norm :180, layer_norm :219, dropout :240,
softmax :253, cross_entropy :259, softmax_with_cross_entropy :276,
sigmoid_cross_entropy_with_logits :292, accuracy :348, auc :366,
im2sequence :508, flash_attention :529). The JAX package computes convolutions, pools and
batch norm outside any Pallas kernel (lax.conv_general_dilated,
lax.reduce_window, jnp arithmetic); here they are torch.nn.functional's
library calls, cuDNN on the card, under the port's TF32-off rule
(fluid/core.py). Under AMP conv2d and flash_attention take bf16 operands
(lowering.amp_cast), as the JAX rules do; a bf16 tower's pools, norms,
softmax and loss then see bf16 activations.
"""
import torch
import torch.nn.functional as F

from ... import ops
from ..lowering import SeqValue, register, data_of, like, amp_cast


def _pair(v):
    return tuple(v) if isinstance(v, (list, tuple)) else (v, v)


def _to_nchw(x, fmt):
    """An NHWC tensor as an NCHW view, and the function that turns a
    result back into an NHWC view."""
    if fmt == 'NHWC':
        return x.permute(0, 3, 1, 2), lambda y: y.permute(0, 2, 3, 1)
    return x, lambda y: y


@register('conv2d')
def _conv2d(ins, attrs, ctx):
    """NCHW or NHWC (`data_format`); the filter is OIHW
    [out_c, in_c / groups, kh, kw] in both, so weights are layout-portable
    (reference operators/conv_op.cc). Under AMP a bf16 convolution (fp32
    accumulation inside cuDNN), its result cast to the input's dtype (the
    JAX :23-50).

    On the card an NHWC tower runs on channels_last memory, which cuDNN's
    tensor-core convolutions take as they are: the NHWC input permuted to
    NCHW is a channels_last view, and so are the results the pools, norms
    and elementwise ops make over it. On the CPU the convolution runs on
    NCHW memory (an NHWC tower's results are NHWC views of NCHW memory):
    torch's CPU convolution backward on channels_last strides (oneDNN) has
    crashed the process when jaxlib was loaded in it too."""
    x = data_of(ins['Input'][0])
    w = data_of(ins['Filter'][0])
    fmt = attrs.get('data_format', 'NCHW')
    xc, back = _to_nchw(x, fmt)
    xc, wc = amp_cast(ctx, xc, w.to(x.dtype))
    memory = torch.channels_last if fmt == 'NHWC' and xc.is_cuda \
        else torch.contiguous_format
    out = F.conv2d(xc.contiguous(memory_format=memory), wc,
                   stride=_pair(attrs.get('strides', 1)),
                   padding=_pair(attrs.get('paddings', 0)),
                   dilation=_pair(attrs.get('dilations', 1)),
                   groups=attrs.get('groups', 1) or 1)
    return {'Output': back(out.to(x.dtype))}


@register('pool2d')
def _pool2d(ins, attrs, ctx):
    """Max or average pooling as the JAX rule's reduce_window (:119-154):
    global pooling takes the whole plane; ceil_mode pads stride - 1 more
    on the bottom and right (torch's ceil_mode drops a window that starts
    in the padding, so the padding is explicit here); an exclusive average
    divides each window by its count of positions inside the input."""
    x = data_of(ins['X'][0])
    xc, back = _to_nchw(x, attrs.get('data_format', 'NCHW'))
    if attrs.get('global_pooling', False):
        ksize, strides, pads = tuple(xc.shape[2:]), (1, 1), (0, 0)
    else:
        ksize = _pair(attrs['ksize'])
        strides = _pair(attrs.get('strides', 1))
        pads = _pair(attrs.get('paddings', 0))
    extra = [s - 1 for s in strides] if attrs.get('ceil_mode', False) \
        else [0, 0]
    # F.pad's order: (left, right, top, bottom)
    pad = (pads[1], pads[1] + extra[1], pads[0], pads[0] + extra[0])
    if attrs.get('pooling_type', 'max') == 'max':
        if any(pad):
            xc = F.pad(xc, pad, value=float('-inf'))
        return {'Out': back(F.max_pool2d(xc, ksize, strides))}
    if not any(pad):
        return {'Out': back(F.avg_pool2d(xc, ksize, strides))}
    out = F.avg_pool2d(F.pad(xc, pad), ksize, strides)
    if attrs.get('exclusive', True):
        # the share of each window inside the input, from a ones plane:
        # the same for every sample and channel
        ones = torch.ones((1, 1) + tuple(xc.shape[2:]), dtype=xc.dtype,
                          device=xc.device)
        out = out / F.avg_pool2d(F.pad(ones, pad), ksize, strides)
    return {'Out': back(out)}


@register('batch_norm')
def _batch_norm(ins, attrs, ctx):
    """reference operators/batch_norm_op.cc; NCHW or NHWC (`data_layout`).

    Train: Y normalizes with the batch's mean and biased variance through
    F.batch_norm(training=True) with no running stats (cuDNN on the card;
    autograd gives its gradient). The running stats are updated here as
    the JAX rule updates them (:207-208): stat * momentum + batch * (1 -
    momentum), with the biased batch variance in fp32; torch's own update
    weights the other way and keeps the unbiased variance, so it never
    sees them. The JAX rule takes the variance in one pass, E[x^2] -
    E[x]^2; torch in a stable one, which agrees with it to the one-pass
    form's own rounding. Test: Y from the running stats, which go back out
    unchanged (the same tensors).

    On a bf16 x, Y is the fp32 normalization rounded to bf16 once: Scale
    and Bias go in as fp32 (their gradients come back in their own
    dtype). With bf16 ones the CPU's kernel rounds along the way (about a
    third of Y's elements land on another bf16 neighbour) and cuDNN
    takes fp32 ones only. The JAX rule computes Y in bf16 arithmetic,
    rounding each step: the two agree within four bf16 ulps of max |Y|
    (tests/test_torch_amp.py)."""
    x = data_of(ins['X'][0])
    scale = data_of(ins['Scale'][0]).to(torch.float32)
    bias = data_of(ins['Bias'][0]).to(torch.float32)
    mean = data_of(ins['Mean'][0])
    var = data_of(ins['Variance'][0])
    eps = attrs.get('epsilon', 1e-5)
    momentum = attrs.get('momentum', 0.9)
    c_axis = 1 if attrs.get('data_layout', 'NCHW') == 'NCHW' else x.ndim - 1
    xc = x.movedim(c_axis, 1)
    if attrs.get('is_test', False) or ctx.is_test:
        y = F.batch_norm(xc, mean, var, scale, bias, training=False, eps=eps)
        return {'Y': y.movedim(1, c_axis), 'MeanOut': mean,
                'VarianceOut': var, 'SavedMean': mean, 'SavedVariance': var}
    y = F.batch_norm(xc, None, None, scale, bias, training=True, eps=eps)
    with torch.no_grad():
        axes = tuple(i for i in range(x.ndim) if i != c_axis)
        b_var, b_mean = torch.var_mean(x.to(torch.float32), dim=axes,
                                       unbiased=False)
        mean_out = mean * momentum + b_mean * (1 - momentum)
        var_out = var * momentum + b_var * (1 - momentum)
    return {'Y': y.movedim(1, c_axis), 'MeanOut': mean_out,
            'VarianceOut': var_out, 'SavedMean': b_mean,
            'SavedVariance': b_var}


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


@register('softmax')
def _softmax(ins, attrs, ctx):
    x = ins['X'][0]
    return {'Out': like(x, torch.softmax(data_of(x), dim=-1))}


def take_along_last(x, idx):
    """x[..., idx] along the last axis with JAX's default gather mode
    (jnp.take_along_axis, as the JAX rules call it): an index in [-n, 0)
    counts from the end, any other index outside [0, n) gives NaN. The
    index is wrapped, clamped and the NaN selected on the device, with no
    host check (a captured step cannot wait for one, and an out-of-range
    gather on the card is a device-side assert)."""
    n = x.shape[-1]
    idx = torch.where(idx < 0, idx + n, idx)
    picked = torch.gather(x, -1, idx.clamp(0, n - 1))
    valid = (idx >= 0) & (idx < n)
    return torch.where(valid, picked, torch.full_like(picked, float('nan')))


@register('cross_entropy')
def _cross_entropy(ins, attrs, ctx):
    """X: probabilities [N, C] (a softmax op before it); Label int64 [N, 1],
    or probabilities with soft_label. -log(p + 1e-8), as the JAX rule; a
    label outside [-C, C) gives NaN (take_along_last)."""
    x = data_of(ins['X'][0])
    label = data_of(ins['Label'][0])
    eps = 1e-8
    if attrs.get('soft_label', False):
        loss = -(label * torch.log(x + eps)).sum(dim=-1, keepdim=True)
    else:
        li = label.long()
        if li.ndim == x.ndim:
            li = li.squeeze(-1)
        loss = -torch.log(take_along_last(x, li.unsqueeze(-1)) + eps)
    return {'Y': like(ins['X'][0], loss)}


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
        loss = -take_along_last(logp, li.unsqueeze(-1))
    return {'Softmax': sm, 'Loss': like(ins['Logits'][0], loss)}


@register('sigmoid_cross_entropy_with_logits')
def _sigmoid_xent(ins, attrs, ctx):
    x = data_of(ins['X'][0])
    label = data_of(ins['Label'][0])
    # max(x, 0) as torch.maximum: at x == 0 its gradient splits between the
    # two operands, as jnp.maximum's does; |x| as where(x >= 0, x, -x),
    # whose gradient at 0 is jnp.abs's 1 (torch.abs has 0), so the gradient
    # at a logit of exactly 0 is -label, as the JAX rule's
    loss = torch.maximum(x, torch.zeros_like(x)) - x * label \
        + torch.log1p(torch.exp(-torch.where(x >= 0, x, -x)))
    return {'Out': like(ins['X'][0], loss)}


@register('accuracy')
def _accuracy(ins, attrs, ctx):
    """Out/Indices: a top_k's values and ids; Label int64 [N, 1]
    (reference operators/accuracy_op.cu). Accuracy has shape [1], as the
    reference's InferShape gives it; Correct and Total are int32
    scalars."""
    idx = data_of(ins['Indices'][0]).long()
    label = data_of(ins['Label'][0]).long()
    if label.ndim < idx.ndim:
        label = label.unsqueeze(-1)
    correct = (idx == label).any(dim=-1)
    num_correct = correct.sum(dtype=torch.int32)
    total = correct.numel()
    return {'Accuracy': (num_correct.to(torch.float32) / total).reshape(1),
            'Correct': num_correct,
            # a device fill: a host tensor copied over would wait for the
            # card, which a captured step cannot do
            'Total': torch.full((), total, dtype=torch.int32,
                                device=idx.device)}


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


@register('im2sequence')
def _im2sequence(ins, attrs, ctx):
    """reference operators/im2sequence_op.cc: an NCHW image as the sequence
    of its flattened patches [N, out_h * out_w, C * kh * kw] (channel
    slowest, then kernel row and column), every row full length."""
    x = data_of(ins['X'][0])
    kh, kw = _pair(attrs['kernels'])
    p = list(attrs.get('paddings', [0, 0, 0, 0]))
    top = p[0]
    left = p[1] if len(p) > 1 else p[0]
    bottom = p[2] if len(p) > 2 else p[0]
    right = p[3] if len(p) > 3 else p[0]
    xp = F.pad(x, (left, right, top, bottom))
    patches = F.unfold(xp, (kh, kw), stride=_pair(attrs.get('strides', 1)))
    seq = patches.transpose(1, 2)                    # [N, L, C * kh * kw]
    lengths = torch.full((x.shape[0],), seq.shape[1], dtype=torch.int64,
                         device=x.device)
    return {'Out': SeqValue(seq, lengths)}


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
    # under AMP bf16 q, k and v (the JAX :545): the kernels' bf16 variants,
    # O in bf16
    q, k, v = amp_cast(ctx, q, k, v)
    out = ops.flash_attention(q, k, v, key_bias=kb,
                              causal=bool(attrs.get('causal', False)),
                              sm_scale=scale)
    return {'Out': out}
