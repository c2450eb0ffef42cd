"""Embedding and variable-length sequence rules.

Parity: the JAX package's fluid/ops_impl/sequence_ops.py (reference
paddle/fluid/operators/{lookup_table,sequence_pool,sequence_softmax,
sequence_expand,sequence_conv,sequence_reshape,sequence_mask,lod_reset,
row_conv,lstm,lstmp,gru,gru_unit,lstm_unit}_op.*). Sequences are padded
lowering.SeqValues [batch, max_len, ...] with their lengths; every rule is
a masked dense op, and a recurrence is a Python loop over the time axis of
the same step the JAX rule hands lax.scan (the plain products stay
torch.matmul, as the JAX rules leave them to XLA). The row-sharded
all_to_all lookup waits for the parallel slice of the port.

What a captured step needs: no rule reads a length on the host. The time
bound is the padded axis, known from the feed's bucket; masks, gathers and
the masked carry are computed on the device. Under build-time shape
inference (meta tensors, the time axis stood in by framework.DYN_DIM) a
recurrence runs its step once and repeats the result along the time axis:
the shapes are those of the full loop.

Ties and masks follow the JAX rules' gradients: relu is torch.maximum
against a 0-d zero, MAX pooling fills pads with the dtype's minimum and
reduces with torch.amax (a tie's gradient shared evenly, as jnp.max), and
the masked carry is the arithmetic vm * new + (1 - vm) * old of the JAX
rule, not a select.
"""
import numpy as np
import torch
import torch.nn.functional as F

from ..core import torch_dtype
from ..lowering import register, data_of, like, SeqValue

@register('lookup_table')
def _lookup_table(ins, attrs, ctx):
    """The rows of W at Ids, with jnp.take's default mode, as the JAX rule
    gathers: an id in [-V, 0) counts from the end, any other id outside
    [0, V) reads a row of NaN. The id is wrapped, clamped and the NaN
    selected on the device, with no host check."""
    w = data_of(ins['W'][0])
    ids_v = ins['Ids'][0]
    ids = data_of(ids_v).long()
    if ids.ndim and ids.shape[-1] == 1:
        ids = ids.squeeze(-1)
    n = w.shape[0]
    ids = torch.where(ids < 0, ids + n, ids)
    valid = (ids >= 0) & (ids < n)
    out = F.embedding(ids.clamp(0, n - 1), w)
    out = torch.where(valid.unsqueeze(-1), out,
                      torch.full_like(out, float('nan')))
    pad = attrs.get('padding_idx')
    if pad is not None and pad >= 0:
        # rows of the padding id read as zeros (the JAX rule zeroes the
        # table row before the gather; masking the gathered rows gives the
        # same values without copying the table)
        out = out.masked_fill((ids == pad).unsqueeze(-1), 0.0)
    from .lod_beam import is_beam_form
    if is_beam_form(ids_v) and out.ndim == ids.ndim + 1:
        # capacity-form beam rows [R] embed to [R, 1, E]: each row is a
        # one-token level-1 group, and the fc ops downstream were
        # shape-inferred for the padded 3-D layout (the JAX :44-47)
        out = out[:, None]
    return {'Out': like(ids_v, out)}


def _seq(v):
    if not isinstance(v, SeqValue):
        raise TypeError("expected a sequence (lod) value, got dense array")
    return v


def _trailing(t, ndim):
    """t [B, T] (or [B]) with singleton dims appended up to ndim."""
    return t.reshape(tuple(t.shape) + (1,) * (ndim - t.ndim))


def _relu(v):
    return torch.maximum(v, torch.tensor(0, dtype=v.dtype))


_ACTS = {'sigmoid': torch.sigmoid, 'tanh': torch.tanh, 'relu': _relu,
         'identity': lambda v: v}


def _scan(step, carry, xs, t):
    """lax.scan over the leading (time) axis of each tensor of xs: carry,
    out = step(carry, x_k) for k < t, the outs stacked on a new leading
    axis. On meta tensors the step runs once and its outs repeat t times
    (build-time shape inference: t is framework.DYN_DIM)."""
    if xs[0].device.type == 'meta':
        carry, out = step(carry, tuple(x[0] for x in xs))
        return carry, tuple(o.unsqueeze(0).expand((t,) + tuple(o.shape))
                            for o in out)
    per_step = [x.unbind(0) for x in xs]
    outs = []
    for k in range(t):
        carry, out = step(carry, tuple(p[k] for p in per_step))
        outs.append(out)
    return carry, tuple(torch.stack(o) for o in zip(*outs))


def _valid_steps(lengths, t, reverse):
    """[T, B] bool: step k of the walk is inside row b's sequence. A
    reverse walk visits the padded axis from its end, so its pads come
    first (the JAX :317-353: the whole axis flips, not each sequence)."""
    steps = torch.arange(t, device=lengths.device)
    if reverse:
        steps = steps.flip(0)
    return steps[:, None] < lengths[None, :]


@register('sequence_pool')
def _sequence_pool(ins, attrs, ctx):
    """Pools each innermost sequence to one row. FIRST and LAST of a
    zero-length row read its step 0, a pad, as the JAX rule does. Nested
    LoD: the pooled rows regroup under the next level out (_regroup_rows),
    which becomes the innermost."""
    x = _seq(ins['X'][0])
    ptype = attrs.get('pooltype', 'AVERAGE').upper()
    data = x.data
    mask = _trailing(x.mask(data.dtype), data.ndim)
    lens = _trailing(torch.clamp_min(x.lengths, 1).to(data.dtype),
                     data.ndim - 1)
    if ptype == 'SUM':
        out = torch.sum(data * mask, dim=1)
    elif ptype == 'AVERAGE':
        out = torch.sum(data * mask, dim=1) / lens
    elif ptype == 'SQRT':
        out = torch.sum(data * mask, dim=1) / torch.sqrt(lens)
    elif ptype == 'MAX':
        lim = torch.finfo(data.dtype) if data.is_floating_point() \
            else torch.iinfo(data.dtype)
        out = torch.amax(torch.where(mask > 0, data, lim.min), dim=1)
    elif ptype == 'FIRST':
        out = data[:, 0]
    elif ptype == 'LAST':
        idx = torch.clamp_min(x.lengths - 1, 0)
        idx = _trailing(idx, data.ndim).expand(
            (data.shape[0], 1) + tuple(data.shape[2:]))
        out = torch.gather(data, 1, idx).squeeze(1)
    else:
        raise ValueError("unknown pooltype %r" % ptype)
    if x.outer_lengths:
        out = _regroup_rows(out, x.outer_lengths[-1],
                            x.outer_lengths[:-1] or None)
    return {'Out': out, 'MaxIndex': None}


def _regroup_rows(rows, group_lens, remaining_outers):
    """[B, ...] rows -> padded SeqValue [G, B, ...] of runs of group_lens
    [G] consecutive rows (the JAX :87-112). The time axis is padded to
    the static bound B."""
    b = rows.shape[0]
    group_lens = group_lens.long()
    starts = torch.cumsum(group_lens, 0) - group_lens
    j = torch.arange(b, device=rows.device)
    idx = torch.clamp(starts[:, None] + j[None, :], 0, b - 1)   # [G, B]
    valid = _trailing(j[None, :] < group_lens[:, None], rows.ndim + 1)
    out = rows[idx]                                              # [G, B, ...]
    out = torch.where(valid, out, 0)
    return SeqValue(out, group_lens, remaining_outers)


@register('sequence_softmax')
def _sequence_softmax(ins, attrs, ctx):
    """Softmax over each sequence's valid steps, in fp32; pads are 0."""
    x = _seq(ins['X'][0])
    data = x.data
    m = _trailing(x.mask(torch.float32), data.ndim)
    logits = torch.where(m > 0, data.to(torch.float32),
                         torch.finfo(torch.float32).min)
    sm = torch.softmax(logits, dim=1) * m
    return {'Out': SeqValue(sm.to(data.dtype), x.lengths, x.outer_lengths)}


@register('sequence_expand')
def _sequence_expand(ins, attrs, ctx):
    """Each row of X broadcast over Y's time steps (reference
    operators/sequence_expand_op.cc, ref_level -1). A sequence X gives
    each row's first step, as the JAX rule does (:141-145). On a
    capacity-form beam Y (the book's LoD beam decoder) each parent row is
    replicated over its selected children (lod_beam.sequence_expand_beam,
    the JAX :128-137)."""
    xv = ins['X'][0]
    from .lod_beam import is_beam_form, sequence_expand_beam
    if is_beam_form(ins['Y'][0]):
        return {'Out': sequence_expand_beam(xv, ins['Y'][0])}
    y = _seq(ins['Y'][0])
    x = data_of(xv)
    if isinstance(xv, SeqValue):
        x = x[:, 0]
    t = y.data.shape[1]
    out = x[:, None].expand((x.shape[0], t) + tuple(x.shape[1:]))
    return {'Out': SeqValue(out, y.lengths, y.outer_lengths)}


@register('sequence_reshape')
def _sequence_reshape(ins, attrs, ctx):
    """Each sequence's rows re-cut to width new_dim; the outer levels are
    dropped, as the JAX rule drops them. Under shape inference the time
    axis stays dynamic."""
    x = _seq(ins['X'][0])
    new_dim = attrs['new_dim']
    b, t, d = x.data.shape
    if x.data.device.type == 'meta':
        from ..framework import DYN_DIM
        return {'Out': SeqValue(x.data.new_empty((b, DYN_DIM, new_dim)),
                                x.lengths)}
    if (t * d) % new_dim:
        raise ValueError('sequence_reshape: %d steps of width %d do not '
                         'cut into rows of %d' % (t, d, new_dim))
    out = x.data.reshape(b, t * d // new_dim, new_dim)
    return {'Out': SeqValue(out, (x.lengths * d) // new_dim)}


@register('sequence_mask')
def _sequence_mask(ins, attrs, ctx):
    """[N, maxlen] mask of lengths X. maxlen must be static: a maxlen read
    from the lengths would be a shape that depends on data."""
    lens = data_of(ins['X'][0]).reshape(-1)
    maxlen = attrs.get('maxlen', -1)
    if maxlen is None or maxlen < 0:
        maxlen = attrs.get('static_maxlen', None)
        if maxlen is None:
            raise ValueError(
                "sequence_mask needs a static maxlen attr (a maximum read "
                "from the lengths would make the output shape depend on "
                "data)")
    steps = torch.arange(maxlen, device=lens.device)
    return {'Y': (steps[None, :] < lens[:, None]).to(
        torch_dtype(attrs.get('out_dtype', 'int64')))}


@register('lod_reset')
def _lod_reset(ins, attrs, ctx):
    """X's rows under a new LoD (reference operators/lod_reset_op.cc). With
    a Y length source the batch stays and only the lengths change; with a
    static target_lod the valid rows are flattened and re-padded into the
    new sequences (an offset past the valid rows reads the edge row
    again, as the JAX rule's clamped gather does). A capacity-form beam Y
    hands X its whole 2-level capacity LoD, beam flag included (the JAX
    :178-196)."""
    xv = ins['X'][0]
    data = data_of(xv)
    if ins.get('Y') and ins['Y']:
        y = ins['Y'][0]
        from .lod_beam import is_beam_form
        if is_beam_form(y):
            return {'Out': SeqValue(data, y.lengths, y.outer_lengths,
                                    beam_cap=True)}
        lens = y.lengths if isinstance(y, SeqValue) \
            else data_of(y).reshape(-1).long()
        if lens.shape[0] != data.shape[0]:
            raise ValueError(
                'lod_reset with a dynamic Y length source cannot regroup '
                'the batch (%d rows -> %d sequences needs static lengths; '
                'pass target_lod instead)' % (data.shape[0], lens.shape[0]))
        return {'Out': SeqValue(data, lens)}
    offsets = np.asarray(attrs['target_lod'])
    if offsets.size == 0 or offsets[0] != 0 or (np.diff(offsets) < 0).any():
        raise ValueError(
            'lod_reset: target_lod must be a non-decreasing level-0 '
            'offsets list starting at 0 (reference lod_reset_op.cc), '
            'got %r' % (list(offsets),))
    new_lens = [int(n) for n in np.diff(offsets)]
    n_new = sum(new_lens)
    dev = data.device
    if isinstance(xv, SeqValue):
        old = xv.lengths.long()
        cum = torch.cumsum(old, 0)
        prev = cum - old
        j = torch.arange(n_new, device=dev)
        row = torch.clamp(torch.searchsorted(cum, j, right=True), 0,
                          data.shape[0] - 1)
        col = torch.clamp(j - prev[row], 0, data.shape[1] - 1)
        flat = data[row, col]                        # [n_new, ...]
    else:
        # a dense input: every row is a token
        flat = data[:n_new]
    maxlen = max(new_lens) if new_lens else 1
    steps = torch.arange(maxlen, device=dev)
    # the static index and mask, built on the device (no host copy)
    mask = torch.stack([steps < n for n in new_lens])
    idx = torch.where(mask, torch.stack(
        [steps + int(o) for o in offsets[:-1]]), torch.zeros_like(steps))
    out = flat[idx]                                  # [n_seqs, maxlen, ...]
    out = torch.where(_trailing(mask, out.ndim), out, 0)
    return {'Out': SeqValue(out, mask.sum(1))}


def _masked(x):
    return x.data * x.mask(x.data.dtype)[..., None]


@register('sequence_conv')
def _sequence_conv(ins, attrs, ctx):
    """Context-window projection (reference operators/sequence_conv_op.cc):
    each step's rows [t + start, t + start + len) concatenated, pads and
    steps off the axis as zeros, times Filter [len * d, out]."""
    x = _seq(ins['X'][0])
    filt = data_of(ins['Filter'][0])
    clen = attrs.get('contextLength', 3)
    cstart = attrs.get('contextStart', -((clen - 1) // 2))
    t = x.data.shape[1]
    xm = _masked(x)
    step = torch.arange(t, device=xm.device)
    cols = []
    for i in range(clen):
        off = cstart + i
        rolled = torch.roll(xm, -off, dims=1)
        valid = (step + off >= 0) & (step + off < t)
        cols.append(torch.where(valid[None, :, None], rolled, 0.0))
    out = torch.matmul(torch.cat(cols, dim=-1), filt)
    return {'Out': SeqValue(out, x.lengths)}


@register('row_conv')
def _row_conv(ins, attrs, ctx):
    """Lookahead convolution (reference operators/row_conv_op.cc): out[t]
    = sum over i < k of Filter[i] * x[t + i]."""
    x = _seq(ins['X'][0])
    filt = data_of(ins['Filter'][0])                 # [future_ctx, d]
    t = x.data.shape[1]
    xm = _masked(x)
    step = torch.arange(t, device=xm.device)
    out = torch.zeros_like(xm)
    for i in range(filt.shape[0]):
        rolled = torch.roll(xm, -i, dims=1)
        valid = step + i < t
        out = out + torch.where(valid[None, :, None], rolled, 0.0) \
            * filt[i][None, None, :]
    return {'Out': SeqValue(out, x.lengths)}


def _lstm_scan(xproj, lengths, w_hid, bias, use_peepholes, cand_act,
               gate_act, cell_act, is_reverse, h0=None, c0=None, proj=None):
    """The LSTM recurrence of the JAX :291-353. xproj [B, T, 4D] is the
    projected input, gates laid out i, f, c, o, hidden weight [D, 4D] (or
    [P, 4D] with a projection [D, P]); peepholes at Bias[..., 4D:7D].
    Returns (hidden [B, T, D or P], cell [B, T, D])."""
    b, t, d4 = xproj.shape
    d = d4 // 4
    ga, ca, cea = _ACTS[gate_act], _ACTS[cand_act], _ACTS[cell_act]
    if h0 is None:
        hdim = proj.shape[1] if proj is not None else d
        h0 = xproj.new_zeros((b, hdim))
    if c0 is None:
        c0 = xproj.new_zeros((b, d))
    gate_bias = bias[..., :d4].reshape(1, d4) if bias is not None else 0.0
    if use_peepholes and bias is not None:
        w_ic = bias[..., d4:d4 + d].reshape(1, d)
        w_fc = bias[..., d4 + d:d4 + 2 * d].reshape(1, d)
        w_oc = bias[..., d4 + 2 * d:d4 + 3 * d].reshape(1, d)
    else:
        w_ic = w_fc = w_oc = None
    xs = xproj.transpose(0, 1)                       # [T, B, 4D]
    if is_reverse:
        xs = xs.flip(0)
    valid_t = _valid_steps(lengths, t, is_reverse)

    def step(carry, inp):
        h, c = carry
        x_t, valid = inp
        g = x_t + torch.matmul(h, w_hid) + gate_bias
        gi, gf, gc, go = torch.chunk(g, 4, dim=-1)
        if w_ic is not None:
            gi = gi + w_ic * c
            gf = gf + w_fc * c
        i = ga(gi)
        f = ga(gf)
        cand = ca(gc)
        c_new = f * c + i * cand
        if w_oc is not None:
            go = go + w_oc * c_new
        o = ga(go)
        h_new = o * cea(c_new)
        if proj is not None:
            h_new = torch.matmul(h_new, proj)
        vm = valid[:, None].to(h_new.dtype)
        h_out = vm * h_new + (1 - vm) * h
        c_out = vm * c_new + (1 - vm) * c
        return (h_out, c_out), (h_out, c_out)

    _, (hs, cs) = _scan(step, (h0, c0), (xs, valid_t), t)
    if is_reverse:
        hs, cs = hs.flip(0), cs.flip(0)
    return hs.transpose(0, 1), cs.transpose(0, 1)


def _lstm_attrs(attrs):
    return (attrs.get('use_peepholes', True),
            attrs.get('candidate_activation', 'tanh'),
            attrs.get('gate_activation', 'sigmoid'),
            attrs.get('cell_activation', 'tanh'),
            attrs.get('is_reverse', False))


def _opt(ins, slot):
    return data_of(ins[slot][0]) if ins.get(slot) else None


@register('lstm')
def _lstm(ins, attrs, ctx):
    x = _seq(ins['Input'][0])
    hs, cs = _lstm_scan(x.data, x.lengths, data_of(ins['Weight'][0]),
                        _opt(ins, 'Bias'), *_lstm_attrs(attrs),
                        h0=_opt(ins, 'H0'), c0=_opt(ins, 'C0'))
    return {'Hidden': SeqValue(hs, x.lengths),
            'Cell': SeqValue(cs, x.lengths),
            'BatchGate': None, 'BatchCellPreAct': None}


@register('lstmp')
def _lstmp(ins, attrs, ctx):
    """The projected LSTM; proj_activation is not applied, as in the JAX
    rule."""
    x = _seq(ins['Input'][0])
    hs, cs = _lstm_scan(x.data, x.lengths, data_of(ins['Weight'][0]),
                        _opt(ins, 'Bias'), *_lstm_attrs(attrs),
                        proj=data_of(ins['ProjWeight'][0]))
    return {'Projection': SeqValue(hs, x.lengths),
            'Cell': SeqValue(cs, x.lengths),
            'BatchGate': None, 'BatchCellPreAct': None,
            'BatchHidden': None, 'OrderedP0': None}


def _gru_gates(x_t, h_prev, w, gate_act, cand_act):
    """One GRU step; w [D, 3D] laid out [update, reset | candidate]
    (reference operators/math/detail/gru_kernel.h). Returns (h_new, r, u,
    c)."""
    d = h_prev.shape[-1]
    g_rz = x_t[:, :2 * d] + torch.matmul(h_prev, w[:, :2 * d])
    u = gate_act(g_rz[:, :d])
    r = gate_act(g_rz[:, d:])
    c = cand_act(x_t[:, 2 * d:] + torch.matmul(r * h_prev, w[:, 2 * d:]))
    return u * h_prev + (1 - u) * c, r, u, c


@register('gru')
def _gru(ins, attrs, ctx):
    x = _seq(ins['Input'][0])                        # [B, T, 3D]
    w = data_of(ins['Weight'][0])
    bias = _opt(ins, 'Bias')
    h0 = _opt(ins, 'H0')
    ga = _ACTS[attrs.get('gate_activation', 'sigmoid')]
    ca = _ACTS[attrs.get('activation', 'tanh')]
    b, t, d3 = x.data.shape
    if h0 is None:
        h0 = x.data.new_zeros((b, d3 // 3))
    xdata = x.data if bias is None else x.data + bias.reshape(1, 1, -1)
    reverse = attrs.get('is_reverse', False)
    xs = xdata.transpose(0, 1)
    if reverse:
        xs = xs.flip(0)
    valid_t = _valid_steps(x.lengths, t, reverse)

    def step(h, inp):
        x_t, valid = inp
        h_new = _gru_gates(x_t, h, w, ga, ca)[0]
        vm = valid[:, None].to(h_new.dtype)
        h_out = vm * h_new + (1 - vm) * h
        return h_out, (h_out,)

    _, (hs,) = _scan(step, h0, (xs, valid_t), t)
    if reverse:
        hs = hs.flip(0)
    return {'Hidden': SeqValue(hs.transpose(0, 1), x.lengths),
            'BatchGate': None, 'BatchResetHiddenPrev': None,
            'BatchHidden': None}


# the reference's activation enum (gru_unit_op.h)
_ACT_ENUM = {0: _ACTS['identity'], 1: _ACTS['sigmoid'], 2: _ACTS['tanh'],
             3: _ACTS['relu']}


@register('gru_unit')
def _gru_unit(ins, attrs, ctx):
    x = data_of(ins['Input'][0])                     # [B, 3D]
    h_prev = data_of(ins['HiddenPrev'][0])
    w = data_of(ins['Weight'][0])
    bias = _opt(ins, 'Bias')

    def act(name, default):
        v = attrs.get(name, default)
        return _ACTS[v] if isinstance(v, str) else _ACT_ENUM[v]

    xb = x if bias is None else x + bias.reshape(1, -1)
    h_new, r, u, _ = _gru_gates(xb, h_prev, w,
                                act('gate_activation', 'sigmoid'),
                                act('activation', 'tanh'))
    return {'Hidden': h_new, 'ResetHiddenPrev': r * h_prev, 'Gate': u}


@register('lstm_unit')
def _lstm_unit(ins, attrs, ctx):
    x = data_of(ins['X'][0])                         # [B, 4D] gates
    c_prev = data_of(ins['C_prev'][0])
    gi, gf, gc, go = torch.chunk(x, 4, dim=-1)
    i = torch.sigmoid(gi)
    f = torch.sigmoid(gf + attrs.get('forget_bias', 0.0))
    o = torch.sigmoid(go)
    c = f * c_prev + i * torch.tanh(gc)
    return {'C': c, 'H': o * torch.tanh(c)}


@register('attention_lstm_decoder')
def _attention_lstm_decoder(ins, attrs, ctx):
    """The fused attention decoder of machine_translation (the JAX
    :478-534): teacher-forced, each step a dot-product attention of the
    decoder state over the encoder's valid steps, then an LSTM cell (gates
    i, f, c, o) on [embedding, context].

      TrgEmb [B, T, E] (sequence), EncOut [B, S, D] (sequence),
      WDec [E + D, 4H], UDec [H, 4H], BDec [1, 4H], WAttnQ [H, D]
      -> Hidden [B, T, H] (sequence; 0 past each target's length)."""
    trg = _seq(ins['TrgEmb'][0])
    enc = _seq(ins['EncOut'][0])
    w_dec = data_of(ins['WDec'][0])
    u_dec = data_of(ins['UDec'][0])
    b_dec = data_of(ins['BDec'][0]) if ins.get('BDec') else 0.0
    w_q = data_of(ins['WAttnQ'][0])
    b, t, _ = trg.data.shape
    h = u_dec.shape[0]
    enc_live = enc.mask(torch.float32) > 0           # [B, S]
    neg = torch.finfo(torch.float32).min
    xs = trg.data.transpose(0, 1)                    # [T, B, E]
    valid_t = _valid_steps(trg.lengths, t, False)
    h0 = trg.data.new_zeros((b, h))
    c0 = trg.data.new_zeros((b, h))

    def step(carry, inp):
        hp, cp = carry
        x_t, valid = inp
        q = torch.matmul(hp, w_q)                    # [B, D]
        scores = torch.einsum('bd,bsd->bs', q, enc.data)
        scores = torch.where(enc_live, scores, neg)
        alpha = torch.softmax(scores, dim=-1)
        ctx_vec = torch.einsum('bs,bsd->bd', alpha, enc.data)
        g = torch.matmul(torch.cat([x_t, ctx_vec], dim=-1), w_dec) \
            + torch.matmul(hp, u_dec) + b_dec
        gi, gf, gc, go = torch.chunk(g, 4, dim=-1)
        i = torch.sigmoid(gi)
        f = torch.sigmoid(gf)
        o = torch.sigmoid(go)
        c_new = f * cp + i * torch.tanh(gc)
        h_new = o * torch.tanh(c_new)
        vm = valid[:, None].to(h_new.dtype)
        return (vm * h_new + (1 - vm) * hp, vm * c_new + (1 - vm) * cp), \
            (vm * h_new,)

    _, (hs,) = _scan(step, (h0, c0), (xs, valid_t), t)
    return {'Hidden': SeqValue(hs.transpose(0, 1), trg.lengths)}
