"""Conv / pool / normalization / dropout / loss / metric / attention rules.

Parity: the JAX package's fluid/ops_impl/nn_ops.py, every rule of it:
conv2d :23, conv3d :52, conv2d_transpose :68, conv3d_transpose :101,
pool2d :157 and pool3d :169 with _pool :119, batch_norm :180, layer_norm
:219, dropout :240, softmax :253, cross_entropy :259,
softmax_with_cross_entropy :276, sigmoid_cross_entropy_with_logits :292,
smooth_l1_loss :300, rank_loss :317, dice_loss :327, huber_loss :338,
accuracy :348, auc :366, lrn :393, prelu :408, bilinear_interp :427 and
nearest_interp :438 with _resize :422, roi_pool :445, mean_iou :491,
im2sequence :508, flash_attention :529. The JAX package computes
convolutions, pools, resizes and batch norm outside any Pallas kernel
(lax.conv_general_dilated, lax.reduce_window, jax.image.resize, jnp
arithmetic); here they are torch.nn.functional's library calls, cuDNN on
the card, under the port's TF32-off rule (fluid/core.py). Under AMP conv2d and flash_attention take bf16 operands
(lowering.amp_cast), as the JAX rules do; a bf16 tower's pools, norms,
softmax and loss then see bf16 activations.
"""
import torch
import torch.nn.functional as F

from ... import ops
from ..lowering import SeqValue, register, data_of, like, amp_cast
from .math_ops import _abs


def _ntuple(v, n):
    return tuple(v) if isinstance(v, (list, tuple)) else (v,) * n


def _pair(v):
    return _ntuple(v, 2)


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


@register('conv3d')
def _conv3d(ins, attrs, ctx):
    """NCDHW, filter OIDHW (the JAX :52-65)."""
    x = data_of(ins['Input'][0])
    w = data_of(ins['Filter'][0])
    return {'Output': F.conv3d(
        x, w.to(x.dtype), stride=_ntuple(attrs.get('strides', 1), 3),
        padding=_ntuple(attrs.get('paddings', 0), 3),
        dilation=_ntuple(attrs.get('dilations', 1), 3),
        groups=attrs.get('groups', 1) or 1)}


@register('conv2d_transpose')
def _conv2d_transpose(ins, attrs, ctx):
    """reference operators/conv_transpose_op.cc; the JAX :68-98 computes
    it as an lhs-dilated convolution. Filter [in_c, out_c / groups, kh,
    kw], torch's own layout for a transposed convolution; the output is
    (H - 1) * stride - 2 * pad + dilation * (k - 1) + 1 on both sides."""
    x = data_of(ins['Input'][0])
    w = data_of(ins['Filter'][0])
    return {'Output': F.conv_transpose2d(
        x, w.to(x.dtype), stride=_pair(attrs.get('strides', 1)),
        padding=_pair(attrs.get('paddings', 0)),
        groups=attrs.get('groups', 1) or 1,
        dilation=_pair(attrs.get('dilations', 1)))}


@register('conv3d_transpose')
def _conv3d_transpose(ins, attrs, ctx):
    """The JAX :101-116, which ignores `groups`: every input channel feeds
    each of the filter's out_c / groups outputs, as here."""
    x = data_of(ins['Input'][0])
    w = data_of(ins['Filter'][0])
    return {'Output': F.conv_transpose3d(
        x, w.to(x.dtype), stride=_ntuple(attrs.get('strides', 1), 3),
        padding=_ntuple(attrs.get('paddings', 0), 3),
        dilation=_ntuple(attrs.get('dilations', 1), 3))}


_MAX_POOL = {2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {2: F.avg_pool2d, 3: F.avg_pool3d}


def _window_pool(x, pool_type, ksize, strides, pads, ceil_mode, exclusive):
    """Max or average pooling of x [N, C, *spatial] over len(ksize) dims,
    as the JAX rule's reduce_window (:119-154): ceil_mode pads stride - 1
    more at the end of each dim (torch's ceil_mode drops a window that
    starts in the padding, so the padding is explicit here); an exclusive
    average divides each window by its count of positions inside the
    input."""
    nd = len(ksize)
    extra = [s - 1 for s in strides] if ceil_mode else [0] * nd
    pad = ()
    for p, e in reversed(list(zip(pads, extra))):    # F.pad: last dim first
        pad += (p, p + e)
    if pool_type == 'max':
        if any(pad):
            x = F.pad(x, pad, value=float('-inf'))
        return _MAX_POOL[nd](x, ksize, strides)
    if not any(pad):
        return _AVG_POOL[nd](x, ksize, strides)
    out = _AVG_POOL[nd](F.pad(x, pad), ksize, strides)
    if exclusive:
        # the share of each window inside the input, from a ones volume:
        # the same for every sample and channel
        ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                          device=x.device)
        out = out / _AVG_POOL[nd](F.pad(ones, pad), ksize, strides)
    return out


def _pool_attrs(x, attrs, nd):
    """(ksize, strides, paddings) of a pool op over x's nd trailing dims;
    global pooling takes the whole volume."""
    if attrs.get('global_pooling', False):
        return tuple(x.shape[2:]), (1,) * nd, (0,) * nd
    return (_ntuple(attrs['ksize'], nd), _ntuple(attrs.get('strides', 1), nd),
            _ntuple(attrs.get('paddings', 0), nd))


@register('pool2d')
def _pool2d(ins, attrs, ctx):
    """NCHW or NHWC (`data_format`) through _window_pool."""
    x = data_of(ins['X'][0])
    xc, back = _to_nchw(x, attrs.get('data_format', 'NCHW'))
    out = _window_pool(xc, attrs.get('pooling_type', 'max'),
                       *_pool_attrs(xc, attrs, 2),
                       attrs.get('ceil_mode', False),
                       attrs.get('exclusive', True))
    return {'Out': back(out)}


@register('pool3d')
def _pool3d(ins, attrs, ctx):
    """NCDHW pooling, the JAX :169-177."""
    x = data_of(ins['X'][0])
    return {'Out': _window_pool(x, attrs.get('pooling_type', 'max'),
                                *_pool_attrs(x, attrs, 3),
                                attrs.get('ceil_mode', False),
                                attrs.get('exclusive', True))}


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


@register('smooth_l1_loss')
def _smooth_l1(ins, attrs, ctx):
    """The JAX :300-314: per-row sums of the smooth L1 of (X - Y) *
    InsideWeight, quadratic below 1 / sigma^2, times OutsideWeight; Out
    [N, 1], Diff the weighted difference."""
    x = data_of(ins['X'][0])
    y = data_of(ins['Y'][0])
    sigma = attrs.get('sigma', 1.0)
    s2 = sigma * sigma
    d = x - y
    if ins.get('InsideWeight'):
        d = d * data_of(ins['InsideWeight'][0])
    ad = _abs(d)
    loss = torch.where(ad < 1.0 / s2, 0.5 * s2 * d * d, ad - 0.5 / s2)
    if ins.get('OutsideWeight'):
        loss = loss * data_of(ins['OutsideWeight'][0])
    return {'Out': loss.reshape(loss.shape[0], -1).sum(1, keepdim=True),
            'Diff': d}


@register('rank_loss')
def _rank_loss(ins, attrs, ctx):
    label = data_of(ins['Label'][0])
    d = data_of(ins['Left'][0]) - data_of(ins['Right'][0])
    return {'Out': torch.log1p(torch.exp(d)) - label * d}


@register('dice_loss')
def _dice_loss(ins, attrs, ctx):
    """X: probabilities; the mean over the batch of 1 - (2 |X L| + eps) /
    (|X| + |L| + eps), a 0-d Out."""
    x = data_of(ins['X'][0])
    label = data_of(ins['Label'][0]).to(x.dtype)
    eps = attrs.get('epsilon', 1e-5)
    red = tuple(range(1, x.ndim))
    inter = 2.0 * torch.sum(x * label, dim=red)
    union = torch.sum(x, dim=red) + torch.sum(label, dim=red)
    return {'Out': torch.mean(1.0 - (inter + eps) / (union + eps))}


@register('huber_loss')
def _huber_loss(ins, attrs, ctx):
    x = data_of(ins['X'][0])
    y = data_of(ins['Y'][0])
    delta = attrs.get('delta', 1.0)
    d = _abs(y - x)
    loss = torch.where(d <= delta, 0.5 * d * d, delta * (d - 0.5 * delta))
    return {'Out': loss, 'Residual': y - x}


@register('lrn')
def _lrn(ins, attrs, ctx):
    """Cross-channel local response normalization of NCHW x (the JAX
    :393-405): x / (k + alpha * sum of n neighbouring squares)^beta,
    the window summed in the JAX rule's order."""
    x = data_of(ins['X'][0])
    n = attrs.get('n', 5)
    half = n // 2
    sq = F.pad(x * x, (0, 0, 0, 0, half, half))
    acc = sum(sq[:, i:i + x.shape[1]] for i in range(n))
    mid = attrs.get('k', 2.0) + attrs.get('alpha', 1e-4) * acc
    return {'Out': x / torch.pow(mid, attrs.get('beta', 0.75)),
            'MidOut': mid}


@register('prelu')
def _prelu(ins, attrs, ctx):
    """where(x >= 0, x, alpha * x): alpha one scalar ('all'), one a
    channel ('channel') or one an element of a sample ('element')."""
    x = data_of(ins['X'][0])
    alpha = data_of(ins['Alpha'][0])
    mode = attrs.get('mode', 'all')
    if mode == 'all':
        a = alpha.reshape(())
    elif mode == 'channel':
        a = alpha.reshape((1, -1) + (1,) * (x.ndim - 2))
    else:
        a = alpha.reshape((1,) + tuple(x.shape[1:]))
    return {'Out': torch.where(x >= 0, x, a * x)}


def _nearest_index(n_in, n_out, device):
    """Source rows of a half-pixel nearest resize of one dim, computed as
    jax.image.resize computes them (floor of (i + 0.5) * n_in / n_out in
    fp32)."""
    pos = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) \
        * n_in / n_out
    return torch.floor(pos).long()


def _triangle_weights(n_in, n_out, device):
    """[n_in, n_out] weights of jax.image.resize's bilinear along one dim
    (jax/_src/image/scale.py compute_weight_mat, antialias on): a triangle
    kernel at the half-pixel sample positions, widened by the scale on a
    downscale, each output's weights normalized, and an output whose
    sample lies past the input's half-pixel border weighted 0."""
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32, device=device)
              + 0.5) * inv_scale - 0.5
    src = torch.arange(n_in, dtype=torch.float32, device=device)
    w = torch.clamp(1.0 - (sample[None, :] - src[:, None]).abs()
                    / kernel_scale, min=0.0)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, 1.0),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _resize(x, out_h, out_w, method):
    """jax.image.resize of NCHW x to [out_h, out_w] (the JAX :422-424).
    Bilinear is separable: along each dim whose size changes, a product
    with that dim's [in, out] triangle weights (_triangle_weights), built
    on x's device, so autograd gives the VJP. Nearest takes each output's
    source row and column as JAX does (torch's 'nearest-exact' rounds its
    scale another way)."""
    if method == 'bilinear':
        if x.shape[2] != out_h:
            wh = _triangle_weights(x.shape[2], out_h, x.device).to(x.dtype)
            x = torch.einsum('nchw,hk->nckw', x, wh)
        if x.shape[3] != out_w:
            ww = _triangle_weights(x.shape[3], out_w, x.device).to(x.dtype)
            x = torch.matmul(x, ww)
        return x
    for dim, n_out in ((2, out_h), (3, out_w)):
        if x.shape[dim] != n_out:
            x = x.index_select(dim, _nearest_index(x.shape[dim], n_out,
                                                   x.device))
    return x


@register('bilinear_interp')
def _bilinear_interp(ins, attrs, ctx):
    if ins.get('OutSize'):
        raise ValueError(
            'image_resize with a runtime OutSize tensor has a data-'
            'dependent shape, which a captured step cannot hold; pass a '
            'static out_shape list')
    return {'Out': _resize(data_of(ins['X'][0]), attrs['out_h'],
                           attrs['out_w'], 'bilinear')}


@register('nearest_interp')
def _nearest_interp(ins, attrs, ctx):
    return {'Out': _resize(data_of(ins['X'][0]), attrs['out_h'],
                           attrs['out_w'], 'nearest')}


@register('roi_pool')
def _roi_pool(ins, attrs, ctx):
    """reference operators/roi_pool_op.cc; the JAX :445-488, every ROI at
    once. ROIs [R, 4] (x1, y1, x2, y2) on image 0, or [R, 5] with the
    image index first. Each pixel of a ROI's rounded box falls in one of
    pooled_height x pooled_width bins, and a bin is the max of its pixels
    (a scatter-max from -inf, whose gradient splits a tie evenly, as
    JAX's scatter-max does); an empty bin is 0."""
    x = data_of(ins['X'][0])
    rois = data_of(ins['ROIs'][0])
    ph, pw = attrs['pooled_height'], attrs['pooled_width']
    scale = attrs.get('spatial_scale', 1.0)
    n, c, h, w = x.shape
    dev = x.device
    if rois.shape[-1] == 5:
        bid = rois[:, 0].long()
        boxes = rois[:, 1:]
    else:
        bid = torch.zeros((rois.shape[0],), dtype=torch.int64, device=dev)
        boxes = rois
    # JAX's x[bid]: an index below 0 wraps once, any other is clamped
    bid = torch.where(bid < 0, bid + n, bid).clamp(0, n - 1)
    img = x.index_select(0, bid)                          # [R, C, H, W]
    r = img.shape[0]
    x1, y1, x2, y2 = (torch.round(boxes[:, i] * scale).long()
                      for i in range(4))
    rh = torch.clamp_min(y2 - y1 + 1, 1).to(torch.float32)
    rw = torch.clamp_min(x2 - x1 + 1, 1).to(torch.float32)
    ys = torch.arange(h, device=dev)
    xs = torch.arange(w, device=dev)
    ybin = torch.floor((ys[None] - y1[:, None]).to(torch.float32)
                       / (rh / ph)[:, None]).long().clamp(0, ph - 1)
    xbin = torch.floor((xs[None] - x1[:, None]).to(torch.float32)
                       / (rw / pw)[:, None]).long().clamp(0, pw - 1)
    inside = (((ys[None] >= y1[:, None]) & (ys[None] <= y2[:, None]))
              [:, :, None]
              & ((xs[None] >= x1[:, None]) & (xs[None] <= x2[:, None]))
              [:, None, :])                               # [R, H, W]
    masked = torch.where(inside[:, None], img,
                         img.new_full((), float('-inf')))
    bins = (ybin[:, :, None] * pw + xbin[:, None, :]).reshape(r, 1, h * w)
    out = img.new_full((r, c, ph * pw), float('-inf')).scatter_reduce(
        2, bins.expand(r, c, h * w), masked.reshape(r, c, h * w), 'amax',
        include_self=True).reshape(r, c, ph, pw)
    return {'Out': torch.where(torch.isfinite(out), out,
                               out.new_zeros(())),
            'Argmax': None}


@register('mean_iou')
def _mean_iou(ins, attrs, ctx):
    """The JAX :491-505 over the confusion counts of label * num_classes +
    prediction (a flat index below 0 wraps once and one past the end is
    dropped, as JAX's scatter-add does). OutWrong and OutCorrect are int64
    counts; the JAX rule carries them as float32."""
    pred = data_of(ins['Predictions'][0]).reshape(-1).long()
    label = data_of(ins['Labels'][0]).reshape(-1).long()
    nc = attrs['num_classes']
    idx = label * nc + pred
    idx = torch.where(idx < 0, idx + nc * nc, idx)
    ok = (idx >= 0) & (idx < nc * nc)
    cm = torch.zeros((nc * nc,), dtype=torch.int64, device=pred.device) \
        .index_add_(0, idx.clamp(0, nc * nc - 1), ok.long()).reshape(nc, nc)
    inter = torch.diagonal(cm)
    union = cm.sum(0) + cm.sum(1) - inter
    valid = union > 0
    iou = torch.where(valid, inter.to(torch.float32)
                      / torch.clamp_min(union, 1).to(torch.float32),
                      torch.zeros((), device=pred.device))
    mean = iou.sum() / torch.clamp_min(valid.sum(), 1).to(torch.float32)
    return {'OutMeanIou': mean, 'OutWrong': cm.sum(1) - inter,
            'OutCorrect': inter}


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
