"""The long-tail rules of the JAX package's fluid/ops_impl/extra_ops.py:
reference operators that exist only at the C++ level (each has a
reference unittest test_<op>_op.py but no v0.14 Python layer), reached
through layers.generate_layer_fn (layers/layer_function_generator.py) and
the `cumsum` layer of layers/ops.py.

Parity, JAX file:line: cumsum :27, l1_norm :44, squared_l2_norm :50,
squared_l2_distance :56, minus :67, fill :74, fill_zeros_like :83, norm
:89, log_loss :100, hinge_loss :109, margin_rank_loss :116,
modified_huber_loss :129, sampling_id :141, conv_shift :152,
bilinear_tensor_product :170, the three sequence rules :183-257,
proximal_gd :260, proximal_adagrad :275, max_pool2d_with_index :313,
unpool :342, spp :372, positive_negative_pair :402, precision_recall
:448, fake_quantize :502, fake_dequantize_max_abs :531,
mine_hard_examples :542 (reference paddle/fluid/operators/<op>_op.*).
`sign` is registered with the activations (math_ops.py).

Every rule keeps its shapes static and reads nothing back to the host, so
a captured step runs it: the sequence rules gather along the time axis at
positions computed on the device, the pooling rules gather their windows
by static indices, the counters keep one output dtype whatever their
inputs, and sampling_id draws from ctx.generator (the JAX rule's
jax.random.categorical is a Gumbel-max too; the two packages' draws
differ, their distributions agree).
"""
import numpy as np
import torch
import torch.nn.functional as F

from ..core import torch_dtype
from ..lowering import register, data_of, like, first_seq, SeqValue
from .math_ops import _abs, _scalar
from .sequence_ops import _trailing


def _along_time(data, idx):
    """data [B, T, ...] gathered at idx [B, T'] along the time axis."""
    idx = idx.reshape(tuple(idx.shape) + (1,) * (data.ndim - 2))
    return torch.take_along_dim(data, idx, dim=1)


@register('sequence_concat')
def _sequence_concat(ins, attrs, ctx):
    """out_i = [a_i; b_i; ...]: corresponding sequences joined along time,
    ragged, in a padded axis of the summed widths."""
    vals = list(ins['X'])
    if not all(isinstance(v, SeqValue) for v in vals):
        raise TypeError('sequence_concat expects lod inputs')
    b = vals[0].data.shape[0]
    total = sum(v.data.shape[1] for v in vals)
    dev = vals[0].data.device
    cols = torch.arange(total, device=dev)[None, :]          # [1, Tt]
    out = vals[0].data.new_zeros((b, total) + tuple(vals[0].data.shape[2:]))
    start = torch.zeros((b, 1), dtype=torch.int64, device=dev)
    for v in vals:
        lens = v.lengths.reshape(b, 1).long()
        local = cols - start                                 # [B, Tt]
        inside = (local >= 0) & (local < lens)
        idx = torch.clamp(local, 0, v.data.shape[1] - 1)
        out = torch.where(_trailing(inside, out.ndim),
                          _along_time(v.data, idx), out)
        start = start + lens
    new_lens = vals[0].lengths.long()
    for v in vals[1:]:
        new_lens = new_lens + v.lengths.long()
    return {'Out': SeqValue(out, new_lens)}


@register('sequence_slice')
def _sequence_slice(ins, attrs, ctx):
    """Each sequence's rows [Offset, Offset + Length), padded to the
    input's time axis."""
    x = ins['X'][0]
    if not isinstance(x, SeqValue):
        raise TypeError('sequence_slice expects a lod input')
    off = data_of(ins['Offset'][0]).reshape(-1).long()
    length = data_of(ins['Length'][0]).reshape(-1).long()
    t = x.data.shape[1]
    cols = torch.arange(t, device=x.data.device)[None, :]
    out = _along_time(x.data, torch.clamp(off[:, None] + cols, 0, t - 1))
    keep = _trailing(cols < length[:, None], out.ndim)
    return {'Out': SeqValue(torch.where(keep, out, 0), length)}


@register('sequence_erase')
def _sequence_erase(ins, attrs, ctx):
    """Every occurrence of the `tokens` removed and each sequence compacted
    to the front, in order (a stable sort on the drop mask)."""
    x = ins['X'][0]
    if not isinstance(x, SeqValue):
        raise TypeError('sequence_erase expects a lod input')
    data = x.data
    flat = data.reshape(data.shape[0], data.shape[1])
    valid = x.mask(torch.bool)
    drop = torch.zeros_like(valid)
    for tok in attrs.get('tokens', []):
        drop = drop | (flat == int(tok))
    keep = valid & ~drop
    order = torch.argsort((~keep).to(torch.int32), dim=1, stable=True)
    compacted = torch.take_along_dim(flat, order, dim=1)
    new_lens = keep.sum(dim=1)
    cols = torch.arange(flat.shape[1], device=flat.device)[None, :]
    compacted = torch.where(cols < new_lens[:, None], compacted, 0)
    return {'Out': SeqValue(compacted.reshape(data.shape), new_lens)}


# -- arithmetic and reductions ------------------------------------------------

@register('cumsum')
def _cumsum(ins, attrs, ctx):
    """Cumulative sum along `axis`; `exclusive` leaves each element out of
    its own sum, `reverse` sums from the end."""
    xv = ins['X'][0]
    x = data_of(xv)
    axis = int(attrs.get('axis', -1))
    exclusive = bool(attrs.get('exclusive', False))
    reverse = bool(attrs.get('reverse', False))
    if reverse:
        x = torch.flip(x, (axis,))
    out = torch.cumsum(x, dim=axis)
    if exclusive:
        out = out - x
    if reverse:
        out = torch.flip(out, (axis,))
    return {'Out': like(xv, out)}


@register('l1_norm')
def _l1_norm(ins, attrs, ctx):
    return {'Out': _abs(data_of(ins['X'][0])).sum().reshape(1)}


@register('squared_l2_norm')
def _squared_l2_norm(ins, attrs, ctx):
    x = data_of(ins['X'][0])
    return {'Out': (x * x).sum().reshape(1)}


@register('squared_l2_distance')
def _squared_l2_distance(ins, attrs, ctx):
    """Each row's squared distance; a Y of one row broadcasts."""
    sub = data_of(ins['X'][0]) - data_of(ins['Y'][0])
    return {'Out': (sub * sub).reshape(sub.shape[0], -1).sum(
        dim=1, keepdim=True), 'sub_result': sub}


@register('minus')
def _minus(ins, attrs, ctx):
    x, y = ins['X'][0], ins['Y'][0]
    return {'Out': like(first_seq(x, y), data_of(x) - data_of(y))}


@register('fill', constant=True)
def _fill(ins, attrs, ctx):
    """attrs['value'] as a tensor of attrs['shape']: through fp32, as the
    JAX rule's jnp.asarray of float64 values gives fp32 with x64 off."""
    vals = np.asarray(attrs['value'], dtype='float64').astype('float32')
    out = torch.from_numpy(vals.reshape([int(s) for s in attrs['shape']]))
    out = out.to(torch_dtype(attrs.get('dtype', 'float32')))
    if ctx.device.type == 'cuda':
        # from pinned memory, without a host sync (a pageable copy waits)
        out = out.pin_memory().to(ctx.device, non_blocking=True)
    return {'Out': out.to(ctx.device)}


@register('fill_zeros_like')
def _fill_zeros_like(ins, attrs, ctx):
    x = ins['X'][0]
    return {'Out': like(x, torch.zeros_like(data_of(x)))}


@register('norm')
def _norm(ins, attrs, ctx):
    """Out = X / sqrt(sum(X^2, axis) + epsilon) (reference norm_op.cc)."""
    x = data_of(ins['X'][0])
    axis = int(attrs.get('axis', 1))
    eps = float(attrs.get('epsilon', 1e-10))
    norm = torch.sqrt((x * x).sum(dim=axis, keepdim=True) + eps)
    return {'Out': x / norm, 'Norm': norm}


# -- losses ---------------------------------------------------------------------

def _relu0(v):
    """max(0, v) as the relu rule takes it (math_ops): at v == 0 the
    gradient splits between the operands, as jnp.maximum's does."""
    return torch.maximum(v, _scalar(v, 0.0))


@register('log_loss')
def _log_loss(ins, attrs, ctx):
    p = data_of(ins['Predicted'][0])
    y = data_of(ins['Labels'][0])
    eps = float(attrs.get('epsilon', 1e-4))
    return {'Loss': -y * torch.log(p + eps)
            - (1.0 - y) * torch.log(1.0 - p + eps)}


@register('hinge_loss')
def _hinge_loss(ins, attrs, ctx):
    logits = data_of(ins['Logits'][0])
    y = data_of(ins['Labels'][0]).to(logits.dtype)
    return {'Loss': _relu0(1.0 - (2.0 * y - 1.0) * logits)}


@register('margin_rank_loss')
def _margin_rank_loss(ins, attrs, ctx):
    """max(0, -label * (x1 - x2) + margin); label 1 or -1 says whether x1
    should rank above x2 (reference margin_rank_loss_op.cc)."""
    label = data_of(ins['Label'][0])
    x1 = data_of(ins['X1'][0])
    x2 = data_of(ins['X2'][0])
    act = -label * (x1 - x2) + float(attrs.get('margin', 0.0))
    return {'Out': _relu0(act), 'Activated': (act > 0).to(x1.dtype)}


@register('modified_huber_loss')
def _modified_huber_loss(ins, attrs, ctx):
    """z = (2y - 1) x: max(0, 1 - z)^2 where z >= -1, else -4z (reference
    modified_huber_loss_op.cc)."""
    x = data_of(ins['X'][0])
    y = data_of(ins['Y'][0]).to(x.dtype)
    z = x * (2.0 * y - 1.0)
    quad = _relu0(1.0 - z)
    return {'Out': torch.where(z >= -1.0, quad * quad, -4.0 * z),
            'IntermediateVal': z}


# -- sampling ---------------------------------------------------------------------

@register('sampling_id')
def _sampling_id(ins, attrs, ctx):
    """One category a row of the probability matrix X, drawn on the device
    from ctx.generator by the Gumbel-max trick over log(max(p, 1e-30)), as
    jax.random.categorical draws it (reference sampling_id_op.cc). An
    entry of 0 is (practically) never drawn. Out is int64."""
    p = data_of(ins['X'][0]).to(torch.float32)
    u = torch.rand(p.shape, generator=ctx.generator, device=p.device)
    gumbel = -torch.log(-torch.log(u))
    logits = torch.log(torch.clamp(p, min=1e-30))
    return {'Out': torch.argmax(logits + gumbel, dim=-1)}


# -- products -----------------------------------------------------------------------

@register('conv_shift')
def _conv_shift(ins, attrs, ctx):
    """Circular cross-correlation (reference conv_shift_op.cc): out[i, j] =
    sum_k x[i, (j + k - M/2) mod N] * y[i, k], the filter width M odd."""
    x = data_of(ins['X'][0])
    y = data_of(ins['Y'][0])
    n, m = x.shape[1], y.shape[1]
    if m % 2 == 0:
        raise ValueError(
            'conv_shift filter width must be odd (reference '
            'conv_shift_op.cc enforcement), got %d' % m)
    dev = x.device
    offs = (torch.arange(n, device=dev)[:, None]
            + torch.arange(m, device=dev)[None, :] - m // 2) % n
    gathered = x[:, offs]                                  # [B, N, M]
    return {'Out': torch.einsum('bnm,bm->bn', gathered, y)}


@register('bilinear_tensor_product')
def _bilinear_tensor_product(ins, attrs, ctx):
    """out[:, k] = x W[k] y^T (+ bias) (reference
    bilinear_tensor_product_op.cc)."""
    x = data_of(ins['X'][0])
    y = data_of(ins['Y'][0])
    w = data_of(ins['Weight'][0])                          # [K, dx, dy]
    out = torch.einsum('bi,kij,bj->bk', x, w, y)
    if ins.get('Bias'):
        out = out + data_of(ins['Bias'][0])
    return {'Out': out}


# -- proximal updates -------------------------------------------------------------

def _prox(z, lr, l1, l2):
    """sign(z) max(|z| - lr l1, 0) / (1 + lr l2): the l1/l2 proximal map."""
    return torch.sign(z) * torch.clamp(_abs(z) - lr * l1, min=0.0) \
        / (1.0 + lr * l2)


@register('proximal_gd')
def _proximal_gd(ins, attrs, ctx):
    """The proximal step of p - lr g (reference proximal_gd_op.cc). Pure,
    as the dense optimizer rules: the Executor binds ParamOut over the
    parameter."""
    p = data_of(ins['Param'][0])
    g = data_of(ins['Grad'][0])
    lr = data_of(ins['LearningRate'][0]).reshape(())
    return {'ParamOut': _prox(p - lr * g, lr, float(attrs.get('l1', 0.0)),
                              float(attrs.get('l2', 0.0)))}


@register('proximal_adagrad')
def _proximal_adagrad(ins, attrs, ctx):
    """Adagrad's accumulator, then the proximal step (reference
    proximal_adagrad_op.h): the adaptive rate scales only the gradient
    step, the l1/l2 shrinkage uses the plain lr."""
    p = data_of(ins['Param'][0])
    g = data_of(ins['Grad'][0])
    m_out = data_of(ins['Moment'][0]) + g * g
    lr = data_of(ins['LearningRate'][0]).reshape(())
    z = p - lr / torch.sqrt(m_out) * g
    return {'ParamOut': _prox(z, lr, float(attrs.get('l1', 0.0)),
                              float(attrs.get('l2', 0.0))),
            'MomentOut': m_out}


# -- pooling ------------------------------------------------------------------------

def _window_views(x, kh, kw, sh, sw, ph, pw, pad_value):
    """[N, C, H, W] -> (windows [N, C, OH, OW, KH*KW], the flat index of
    each window element in the PADDED H*W grid [OH, OW, KH*KW], the padded
    width): the windows gathered by static indices (the JAX :290)."""
    n, c, h, w = x.shape
    xp = F.pad(x, (pw, pw, ph, ph), value=pad_value)
    hp, wp = h + 2 * ph, w + 2 * pw
    oh = (hp - kh) // sh + 1
    ow = (wp - kw) // sw + 1
    dev = x.device
    r = torch.arange(oh, device=dev)[:, None] * sh \
        + torch.arange(kh, device=dev)[None, :]              # [OH, KH]
    cc = torch.arange(ow, device=dev)[:, None] * sw \
        + torch.arange(kw, device=dev)[None, :]              # [OW, KW]
    t = xp.index_select(2, r.reshape(-1)).reshape(n, c, oh, kh, wp)
    t = t.index_select(4, cc.reshape(-1)).reshape(n, c, oh, kh, ow, kw)
    win = t.permute(0, 1, 2, 4, 3, 5).reshape(n, c, oh, ow, kh * kw)
    fidx = (r[:, None, :, None] * wp
            + cc[None, :, None, :]).reshape(oh, ow, kh * kw)
    return win, fidx, wp


@register('max_pool2d_with_index')
def _max_pool2d_with_index(ins, attrs, ctx):
    """Max pool that also gives each maximum's flat index in its channel's
    H*W map (reference pool_with_index_op.cc), which unpool reads: the
    first maximum of a window, padding never chosen over a value; a
    window's position in the padding gives index 0. Mask is int32, as the
    JAX rule's. global_pooling takes the whole map."""
    x = data_of(ins['X'][0])
    if attrs.get('global_pooling', False):
        kh, kw = x.shape[2], x.shape[3]
        sh = sw = 1
        ph = pw = 0
    else:
        kh, kw = [int(k) for k in attrs['ksize']]
        sh, sw = [int(s) for s in attrs.get('strides', [1, 1])]
        ph, pw = [int(p) for p in attrs.get('paddings', [0, 0])]
    win, fidx, wp = _window_views(x, kh, kw, sh, sw, ph, pw,
                                  torch.finfo(x.dtype).min)
    arg = torch.argmax(win, dim=-1, keepdim=True)          # first maximum
    out = torch.take_along_dim(win, arg, dim=-1)[..., 0]
    flat_p = torch.take_along_dim(fidx.expand(win.shape), arg,
                                  dim=-1)[..., 0]
    rr = flat_p // wp - ph
    cc = flat_p % wp - pw
    inside = (rr >= 0) & (rr < x.shape[2]) & (cc >= 0) & (cc < x.shape[3])
    flat = torch.where(inside, rr * x.shape[3] + cc, 0)
    return {'Out': out, 'Mask': flat.to(torch.int32)}


@register('unpool')
def _unpool(ins, attrs, ctx):
    """Max unpooling (reference unpool_op.cc): each pooled value written to
    its recorded position in a zero canvas of ((in - 1) stride - 2 pad +
    ksize) per dim, or of attrs['output_size'].

    Overlapping windows record one position more than once, always with
    the same value. The JAX rule's .at[].set keeps one writer a position
    and passes the gradient to that writer alone: the last in row-major
    order, as XLA's scatter applies its updates on the CPU. So does this
    rule, on the device and deterministically: each position's writer is
    the largest update index aiming at it (a scatter-max of the indices),
    and the canvas is a scatter-add of the writers' values alone. A
    position outside the canvas is dropped, as JAX's scatter drops it."""
    x = data_of(ins['X'][0])                               # [N, C, IH, IW]
    if attrs.get('unpooling_type', 'max') != 'max':
        raise ValueError('only max unpooling exists (reference parity)')
    n, c, ih, iw = x.shape
    if attrs.get('output_size'):
        oh, ow = [int(v) for v in attrs['output_size']]
    else:
        kh, kw = [int(k) for k in attrs['ksize']]
        sh, sw = [int(s) for s in attrs.get('strides', [1, 1])]
        ph, pw = [int(p) for p in attrs.get('paddings', [0, 0])]
        oh = (ih - 1) * sh - 2 * ph + kh
        ow = (iw - 1) * sw - 2 * pw + kw
    size = oh * ow
    flat_x = x.reshape(n, c, -1)
    idx = data_of(ins['Indices'][0]).reshape(n, c, -1).long()
    valid = (idx >= 0) & (idx < size)
    # a dropped update aims at a scratch position past the canvas
    idx = torch.where(valid, idx, size)
    order = torch.arange(idx.shape[-1], device=x.device).expand(idx.shape)
    writer = torch.full((n, c, size + 1), -1, dtype=torch.int64,
                        device=x.device).scatter_reduce(
                            2, idx, order, 'amax')
    wins = valid & (torch.gather(writer, 2, idx) == order)
    canvas = x.new_zeros((n, c, size + 1)).scatter_add(
        2, idx, torch.where(wins, flat_x, torch.zeros_like(flat_x)))
    return {'Out': canvas[..., :size].reshape(n, c, oh, ow)}


@register('spp')
def _spp(ins, attrs, ctx):
    """Spatial pyramid pooling (reference spp_op.h): level l pools with a
    kernel of ceil(H / 2^l), its own stride, padding (kernel 2^l - H + 1)
    // 2; each level flattened channel-major, the levels concatenated to
    [N, C (4^L - 1) / 3]. A tie of maxima shares the gradient, as jnp.max's
    does (amax); avg divides by the whole kernel, padding included."""
    x = data_of(ins['X'][0])
    levels = int(attrs['pyramid_height'])
    ptype = attrs.get('pooling_type', 'max')
    n, c, h, w = x.shape
    outs = []
    for level in range(levels):
        bins = 2 ** level
        kh = int(np.ceil(h / bins))
        kw = int(np.ceil(w / bins))
        ph = (kh * bins - h + 1) // 2
        pw = (kw * bins - w + 1) // 2
        if ptype == 'max':
            win = _window_views(x, kh, kw, kh, kw, ph, pw,
                                torch.finfo(x.dtype).min)[0]
            red = win.amax(dim=-1)
        else:
            win = _window_views(x, kh, kw, kh, kw, ph, pw, 0.0)[0]
            red = win.sum(dim=-1) / float(kh * kw)
        outs.append(red.reshape(n, c * bins * bins))
    return {'Out': torch.cat(outs, dim=1)}


# -- counters -------------------------------------------------------------------

@register('positive_negative_pair')
def _positive_negative_pair(ins, attrs, ctx):
    """Ranking pair counts per query (reference
    positive_negative_pair_op.h): over the pairs of one query whose labels
    differ, a pair is positive where the scores order as the labels,
    negative where inverted, neutral at a score tie; a pair weighs the
    mean of its two weights. The accumulators add in only when all three
    are wired. Dense [n, n] over the batch, masked to pairs of one query;
    every output fp32 [1]."""
    score = data_of(ins['Score'][0]).to(torch.float32)
    label = data_of(ins['Label'][0]).to(torch.float32).reshape(-1)
    query = data_of(ins['QueryID'][0]).reshape(-1)
    s = score[:, int(attrs.get('column', -1))]
    n = s.shape[0]
    if ins.get('Weight'):
        w = data_of(ins['Weight'][0]).to(torch.float32).reshape(-1)
    else:
        w = torch.ones((n,), dtype=torch.float32, device=s.device)
    upper = torch.ones((n, n), dtype=torch.bool, device=s.device).triu(1)
    consider = (query[:, None] == query[None, :]) \
        & (label[:, None] != label[None, :]) & upper
    pw = (w[:, None] + w[None, :]) * 0.5
    s_d = s[:, None] - s[None, :]
    agree = torch.sign(s_d) == torch.sign(label[:, None] - label[None, :])
    tie = s_d == 0
    zero = torch.zeros_like(pw)

    def total(m):
        return torch.where(m, pw, zero).sum().reshape(1)

    pos = total(consider & ~tie & agree)
    neg = total(consider & ~tie & ~agree)
    neu = total(consider & tie)
    if ins.get('AccumulatePositivePair') and \
            ins.get('AccumulateNegativePair') and \
            ins.get('AccumulateNeutralPair'):
        pos = pos + data_of(ins['AccumulatePositivePair'][0]).reshape(1)
        neg = neg + data_of(ins['AccumulateNegativePair'][0]).reshape(1)
        neu = neu + data_of(ins['AccumulateNeutralPair'][0]).reshape(1)
    return {'PositivePair': pos, 'NegativePair': neg, 'NeutralPair': neu}


def _one_hot(ids, c):
    """jax.nn.one_hot: fp32 rows, all zero for an id outside [0, c)."""
    return (ids[:, None] == torch.arange(c, device=ids.device)[None, :]).to(
        torch.float32)


def _ratio(num, den):
    """num / den where den > 0, else 1 (an empty class scores 1.0)."""
    return torch.where(den > 0, num / torch.clamp(den, min=1e-12),
                       torch.ones_like(num))


def _f1(p, r):
    return torch.where(p + r > 0, 2 * p * r / torch.clamp(p + r, min=1e-12),
                       torch.zeros_like(p))


def _pr_metrics(st):
    """Macro precision, recall and F1 (the F1 of the macro means), micro
    precision, recall and F1 of [C, 4] states (TP FP TN FN)."""
    tp, fp, fn = st[:, 0], st[:, 1], st[:, 3]
    prec, rec = _ratio(tp, tp + fp), _ratio(tp, tp + fn)
    macro_p, macro_r = prec.mean(), rec.mean()
    stp, sfp, sfn = tp.sum(), fp.sum(), fn.sum()
    micro_p, micro_r = _ratio(stp, stp + sfp), _ratio(stp, stp + sfn)
    return torch.stack([macro_p, macro_r, _f1(macro_p, macro_r),
                        micro_p, micro_r, _f1(micro_p, micro_r)])


@register('precision_recall')
def _precision_recall(ins, attrs, ctx):
    """Multi-class precision and recall (reference precision_recall_op.h):
    the batch's [C, 4] states (TP FP TN FN, fp32), their metrics and the
    accumulated states' metrics."""
    idx = data_of(ins['Indices'][0]).reshape(-1).long()
    label = data_of(ins['Labels'][0]).reshape(-1).long()
    c = int(attrs['class_number'])
    if ins.get('Weights'):
        w = data_of(ins['Weights'][0]).to(torch.float32).reshape(-1)
    else:
        w = torch.ones(idx.shape, dtype=torch.float32, device=idx.device)
    oh_pred, oh_lbl = _one_hot(idx, c), _one_hot(label, c)
    wc = w[:, None]
    tp = (oh_pred * oh_lbl * wc).sum(dim=0)
    fp = (oh_pred * (1 - oh_lbl) * wc).sum(dim=0)
    fn = (oh_lbl * (1 - oh_pred) * wc).sum(dim=0)
    tn = w.sum() - tp - fp - fn
    batch_states = torch.stack([tp, fp, tn, fn], dim=1)     # [C, 4]
    states = batch_states
    if ins.get('StatesInfo'):
        states = states + data_of(ins['StatesInfo'][0]).to(torch.float32)
    return {'BatchMetrics': _pr_metrics(batch_states),
            'AccumMetrics': _pr_metrics(states),
            'AccumStatesInfo': states}


# -- quantization ---------------------------------------------------------------

@register('fake_quantize')
def _fake_quantize(ins, attrs, ctx):
    """Quantization-aware training's preview (reference
    fake_quantize_op.cc, quantize_type 'abs_max'): Out = round(x / max|x|
    (2^(bits-1) - 1)), rounding half away from zero (sign floor(|q| +
    0.5)), as the reference's Eigen round does. Out's gradient is zero
    almost everywhere, as the JAX rule's: no straight-through estimator."""
    qtype = attrs.get('quantize_type', 'abs_max')
    if qtype != 'abs_max':
        raise ValueError(
            "fake_quantize supports quantize_type='abs_max' (got %r), as "
            "the JAX rule does" % qtype)
    x = data_of(ins['X'][0])
    qmax = float((1 << (int(attrs.get('bit_length', 8)) - 1)) - 1)
    scale = _abs(x).amax()
    q = x / torch.clamp(scale, min=1e-30) * qmax
    res = {'Out': torch.sign(q) * torch.floor(_abs(q) + 0.5),
           'OutMovingScale': scale.reshape(1)}
    if ins.get('InScales'):
        res['OutScales'] = data_of(ins['InScales'][0])
    if ins.get('InCurrentIter'):
        res['OutCurrentIter'] = data_of(ins['InCurrentIter'][0])
    return res


@register('fake_dequantize_max_abs')
def _fake_dequantize_max_abs(ins, attrs, ctx):
    """Out = x scale / (2^(bits-1) - 1), in fp32 (reference
    fake_dequantize_op.cc)."""
    x = data_of(ins['X'][0])
    scale = data_of(ins['Scale'][0]).reshape(())
    bits = int(attrs.get('num_bits', attrs.get('bit_length', 8)))
    qmax = float((1 << (bits - 1)) - 1)
    return {'Out': x.to(torch.float32) * scale / qmax}


# -- mining ---------------------------------------------------------------------

@register('mine_hard_examples')
def _mine_hard_examples(ins, attrs, ctx):
    """Hard-negative mining, mining_type 'max_negative' (reference
    detection/mine_hard_examples_op.cc): the candidates are the unmatched
    priors with MatchDist below neg_dist_threshold; an image keeps the
    min(num_pos neg_pos_ratio, candidates) of highest ClsLoss, ranked by a
    stable sort (ties by prior index, as jnp.argsort), and NegIndices
    lists them ascending as a padded sequence [N, P, 1] with its lengths.
    Its ids and lengths are int64, the port's index dtype (int32 in the
    JAX rule); no host read."""
    if attrs.get('mining_type', 'max_negative') != 'max_negative':
        raise ValueError(
            "mine_hard_examples supports mining_type='max_negative'")
    cls_loss = data_of(ins['ClsLoss'][0]).to(torch.float32)
    match = data_of(ins['MatchIndices'][0]).to(torch.int32)
    dist = data_of(ins['MatchDist'][0]).to(torch.float32)
    ratio = float(attrs.get('neg_pos_ratio', 3.0))
    thresh = float(attrs.get('neg_dist_threshold', 0.5))
    p = cls_loss.shape[1]
    cand = (match == -1) & (dist < thresh)                  # [N, P]
    num_pos = (match != -1).sum(dim=1)
    n_sel = torch.minimum((num_pos.to(torch.float32) * ratio).long(),
                          cand.sum(dim=1))
    masked = torch.where(cand, cls_loss, float('-inf'))
    order = torch.argsort(-masked, dim=1, stable=True)      # loss desc
    rank_of = torch.argsort(order, dim=1, stable=True)      # prior -> rank
    selected = cand & (rank_of < n_sel[:, None])
    cols = torch.arange(p, device=cls_loss.device)[None, :]
    key = torch.where(selected, cols, p)                    # pads sort last
    neg_sorted = torch.sort(key, dim=1, stable=True).values
    lens = selected.sum(dim=1)
    neg = torch.where(cols < lens[:, None], neg_sorted, 0)
    return {'NegIndices': SeqValue(neg[..., None], lens),
            'UpdatedMatchIndices': match}
