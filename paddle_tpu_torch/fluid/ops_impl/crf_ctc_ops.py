"""CRF, CTC, edit-distance and chunk-eval rules.

Parity: the JAX package's fluid/ops_impl/crf_ctc_ops.py (reference
paddle/fluid/operators/{linear_chain_crf,crf_decoding,ctc_align,
edit_distance,warpctc,chunk_eval}_op.*). Every rule is a masked dense
computation over padded [batch, max_len, ...] SeqValues. The CRF forward
and Viterbi passes, the CTC alpha recursion and the edit-distance rows
are Python loops over the padded axis (sequence_ops._scan) of the step the
JAX rule hands lax.scan; their gradients are torch autograd through the
loop, as the JAX gradients are jax.grad of the scan.

What a captured step needs: no rule reads a length on the host. Masks come
from arange against the lengths on the device, the outputs keep one dtype
whatever the data (ids, paths, SequenceNum and the chunk counts int64;
the JAX package's are int32 with x64 off: the values agree).

Index modes follow JAX, so an out-of-range label gives JAX's values on the
card instead of a device-side assert: a gather along the class axis
(jnp.take_along_axis) wraps [-C, 0) and reads NaN past C
(nn_ops.take_along_last); a plain index (a[label]) wraps once from the end
and clamps into [0, C), and passes no gradient to the clamped row
(_jax_index).
"""
import torch

from ..lowering import register, data_of, like, SeqValue
from .nn_ops import take_along_last
from .sequence_ops import _scan

_NEG = -1e30


def _ids2d(v):
    """SeqValue/tensor of ids [B, T, 1] or [B, T] -> int64 [B, T]."""
    x = data_of(v).long()
    if x.ndim == 3 and x.shape[-1] == 1:
        x = x.squeeze(-1)
    return x


def _lengths(v, t):
    """int64 [B]: a sequence's lengths, or t for every row of a dense
    value."""
    if isinstance(v, SeqValue):
        return v.lengths.long()
    x = data_of(v)
    return torch.full((x.shape[0],), t, dtype=torch.int64, device=x.device)


def _jax_index(x, *idxs):
    """x[i, j, ...] with int arrays, in JAX's default index mode: an index
    below 0 counts once from the end, then each is clamped into range for
    the value, and an element read through an out-of-range index gets no
    gradient (JAX's scatter-add drops it)."""
    inb, clamped = None, []
    for d, idx in enumerate(idxs):
        n = x.shape[d]
        idx = torch.where(idx < 0, idx + n, idx)
        ok = (idx >= 0) & (idx < n)
        inb = ok if inb is None else inb & ok
        clamped.append(idx.clamp(0, n - 1))
    picked = x[tuple(clamped)]
    return torch.where(inb, picked, picked.detach())


def _time_major(x):
    """[B, T, ...] -> [T, B, ...], contiguous, for _scan's per-step
    views."""
    return x.transpose(0, 1).contiguous()


def _loop(step, carry, xs, t):
    """_scan over t steps; with t 0 (a batch of one-step sequences) the
    carry comes back as it went in, with None for the outputs."""
    if t == 0:
        return carry, None
    return _scan(step, carry, xs, t)


# ---------------------------------------------------------------------------
# linear_chain_crf
# ---------------------------------------------------------------------------

@register('linear_chain_crf')
def _linear_chain_crf(ins, attrs, ctx):
    """Transition layout (reference linear_chain_crf_op.h): row 0 = start
    weights a, row 1 = stop weights b, rows 2: = pairwise w[prev, cur].
    LogLikelihood is the per-sequence negative log-likelihood [B, 1] (the
    book models feed it straight into mean() as the cost)."""
    em_v = ins['Emission'][0]
    emission = data_of(em_v).to(torch.float32)           # [B, T, C]
    transition = data_of(ins['Transition'][0]).to(torch.float32)
    label = _ids2d(ins['Label'][0])                       # [B, T]
    b_, t, c = emission.shape
    a, b, w = transition[0], transition[1], transition[2:]
    lens = _lengths(em_v, t)
    valid = torch.arange(t, device=emission.device)[None, :] \
        < lens[:, None]                                   # [B, T]

    # log partition: the alpha recursion over time
    alpha0 = a[None, :] + emission[:, 0]                  # [B, C]

    def fwd(alpha, xs):
        em_t, valid_t = xs                                # [B, C], [B]
        nxt = torch.logsumexp(alpha[:, :, None] + w[None], dim=1) + em_t
        alpha = torch.where(valid_t[:, None], nxt, alpha)
        return alpha, (alpha,)

    alpha_t, alphas = _loop(fwd, alpha0,
                            (_time_major(emission[:, 1:]),
                             _time_major(valid[:, 1:])), t - 1)
    log_z = torch.logsumexp(alpha_t + b[None, :], dim=-1)           # [B]

    # the gold path's score
    zero = emission.new_zeros(())
    em_score = torch.sum(torch.where(
        valid, take_along_last(emission, label[:, :, None])[:, :, 0], zero),
        dim=1)
    start_score = _jax_index(a, label[:, 0])
    last_idx = torch.clamp_min(lens - 1, 0)
    last_lab = torch.gather(label, 1, last_idx[:, None])[:, 0]
    stop_score = _jax_index(b, last_lab)
    trans_pairs = _jax_index(w, label[:, :-1], label[:, 1:])
    trans_score = torch.sum(torch.where(valid[:, 1:], trans_pairs, zero),
                            dim=1)
    path = em_score + start_score + stop_score + trans_score

    nll = (log_z - path)[:, None]                                    # [B, 1]
    alphas_full = alpha0[:, None] if alphas is None else torch.cat(
        [alpha0[:, None], alphas[0].transpose(0, 1)], dim=1)
    return {'LogLikelihood': nll,
            'Alpha': like(em_v, alphas_full),
            'EmissionExps': like(em_v, torch.exp(
                emission - torch.amax(emission, dim=-1, keepdim=True))),
            'TransitionExps': torch.exp(transition)}


@register('crf_decoding')
def _crf_decoding(ins, attrs, ctx):
    """Viterbi decode; with Label given, the per-token 0/1 match mask
    instead of the path (reference crf_decoding_op.h). The argmaxes take
    the first maximum, as jnp.argmax does; a padded step keeps the
    identity pointer, so the backtrace passes the pads unchanged."""
    em_v = ins['Emission'][0]
    emission = data_of(em_v).to(torch.float32)           # [B, T, C]
    transition = data_of(ins['Transition'][0]).to(torch.float32)
    b_, t, c = emission.shape
    a, b, w = transition[0], transition[1], transition[2:]
    dev = emission.device
    lens = _lengths(em_v, t)
    valid = torch.arange(t, device=dev)[None, :] < lens[:, None]
    ident = torch.arange(c, device=dev)[None, :]

    delta0 = a[None, :] + emission[:, 0]

    def fwd(delta, xs):
        em_t, valid_t = xs
        scores = delta[:, :, None] + w[None]              # [B, C, C]
        best, best_prev = torch.max(scores, dim=1)
        new_delta = torch.where(valid_t[:, None], best + em_t, delta)
        ptr = torch.where(valid_t[:, None], best_prev, ident)
        return new_delta, (ptr,)

    delta_t, ptrs = _loop(fwd, delta0,
                          (_time_major(emission[:, 1:]),
                           _time_major(valid[:, 1:])), t - 1)
    last = torch.argmax(delta_t + b[None, :], dim=-1)     # [B]

    if ptrs is None:
        path = last[:, None]
    else:
        def back(state, xs):
            state = torch.gather(xs[0], 1, state[:, None])[:, 0]
            return state, (state,)

        # the reverse scan: ptrs from the last step back, outputs restored
        # to time order
        _, rev = _scan(back, last, (ptrs[0].flip(0),), t - 1)
        path = torch.cat([rev[0].flip(0).transpose(0, 1), last[:, None]],
                         dim=1)
    path = torch.where(valid, path, torch.zeros_like(path))

    if 'Label' in ins and ins['Label']:
        label = _ids2d(ins['Label'][0])
        path = torch.where(valid, (path == label).long(),
                           torch.zeros_like(path))
    return {'ViterbiPath': like(em_v, path[:, :, None])}


# ---------------------------------------------------------------------------
# CTC
# ---------------------------------------------------------------------------

def _compact(ids, keep):
    """Stable left-compaction of the kept tokens (static shapes): positions
    sorted by (dropped, index), lengths recounted (int64)."""
    t = ids.shape[1]
    pos = torch.arange(t, device=ids.device)[None, :].expand(ids.shape)
    order = torch.argsort(torch.where(keep, pos, torch.full_like(pos, t + 1)),
                          dim=1, stable=True)
    packed = torch.gather(ids, 1, order)
    new_lens = keep.sum(dim=1, dtype=torch.int64)
    return packed, new_lens


@register('ctc_align')
def _ctc_align(ins, attrs, ctx):
    """Greedy CTC decode: argmax per frame (the first maximum), merge
    repeats, drop blanks; the kept tokens stably moved left."""
    x_v = ins['Input'][0]
    x = data_of(x_v)
    if x.ndim == 3:                                       # probs [B, T, C]
        ids = torch.argmax(x, dim=-1)
    else:
        ids = _ids2d(x_v)
    b_, t = ids.shape
    blank = int(attrs.get('blank', 0))
    merge = bool(attrs.get('merge_repeated', True))
    lens = _lengths(x_v, t)
    steps = torch.arange(t, device=ids.device)[None, :]
    valid = steps < lens[:, None]

    prev = torch.cat([torch.full_like(ids[:, :1], -1), ids[:, :-1]], dim=1)
    keep = valid & (ids != blank)
    if merge:
        keep = keep & (ids != prev)
    packed, new_lens = _compact(ids, keep)
    packed = torch.where(steps < new_lens[:, None], packed,
                         torch.zeros_like(packed))
    return {'Output': SeqValue(packed[:, :, None], new_lens)}


@register('warpctc')
def _warpctc(ins, attrs, ctx):
    """CTC loss: the log-space alpha recursion over the blank-interleaved
    label (Graves 2006). Its gradient is autograd through the loop, so the
    reference's hand-written WarpCTCGrad output is None, as in the JAX
    rule."""
    logits_v = ins['Logits'][0]
    logits = data_of(logits_v).to(torch.float32)         # [B, T, C]
    label = _ids2d(ins['Label'][0])                       # [B, L]
    b_, t, c = logits.shape
    dev = logits.device
    n_lab = label.shape[1]
    blank = int(attrs.get('blank', 0))
    t_lens = _lengths(logits_v, t)
    l_lens = _lengths(ins['Label'][0], n_lab)

    logp = torch.log_softmax(logits, dim=-1)
    # the extended sequence: blank, y1, blank, y2, ..., blank (2L + 1)
    s = 2 * n_lab + 1
    ext = torch.full((b_, s), blank, dtype=torch.int64, device=dev)
    ext[:, 1::2] = label
    ext_len = 2 * l_lens + 1
    in_ext = torch.arange(s, device=dev)[None, :] < ext_len[:, None]

    # a path may skip from s-2 to s where e[s] is no blank and differs
    # from e[s-2]
    ext_m2 = torch.cat([torch.full_like(ext[:, :2], -1), ext[:, :-2]], dim=1)
    can_skip = (ext != blank) & (ext != ext_m2)
    neg = logits.new_full((), _NEG)

    lp_ext0 = take_along_last(logp[:, 0], ext)            # [B, S]
    alpha0 = [lp_ext0[:, :1]]
    if s > 1:
        alpha0.append(torch.where(l_lens[:, None] >= 1, lp_ext0[:, 1:2],
                                  neg))
        alpha0.append(neg.expand(b_, s - 2))
    alpha0 = torch.cat(alpha0, dim=1)

    def step(alpha, xs):
        lp_t, valid_t = xs                                # [B, C], [B]
        lp_ext = take_along_last(lp_t, ext)               # [B, S]
        a1 = torch.cat([neg.expand(b_, 1), alpha[:, :-1]], dim=1)
        a2 = torch.cat([neg.expand(b_, 2), alpha[:, :-2]], dim=1)[:, :s]
        a2 = torch.where(can_skip, a2, neg)
        nxt = torch.logaddexp(torch.logaddexp(alpha, a1), a2) + lp_ext
        nxt = torch.where(in_ext, nxt, neg)
        return torch.where(valid_t[:, None], nxt, alpha), ()

    valid_t = torch.arange(t, device=dev)[None, :] < t_lens[:, None]
    alpha_t, _ = _loop(step, alpha0, (_time_major(logp[:, 1:]),
                                      _time_major(valid_t[:, 1:])), t - 1)

    idx_last = torch.clamp_min(ext_len - 1, 0)
    idx_prev = torch.clamp_min(ext_len - 2, 0)
    a_last = torch.gather(alpha_t, 1, idx_last[:, None])[:, 0]
    a_prev = torch.gather(alpha_t, 1, idx_prev[:, None])[:, 0]
    # an empty label (ext_len 1): only the all-blank path exists
    ll = torch.logaddexp(a_last, torch.where(ext_len >= 2, a_prev, neg))
    loss = -ll
    if attrs.get('norm_by_times'):
        loss = loss / torch.clamp_min(t_lens, 1).to(torch.float32)
    return {'Loss': loss[:, None], 'WarpCTCGrad': None}


# ---------------------------------------------------------------------------
# edit_distance
# ---------------------------------------------------------------------------

def _strip_tokens(ids, lens, ignored):
    """Remove the ignored token ids, compacting left."""
    keep = torch.arange(ids.shape[1], device=ids.device)[None, :] \
        < lens[:, None]
    for tok in ignored:
        keep = keep & (ids != int(tok))
    return _compact(ids, keep)


@register('edit_distance')
def _edit_distance(ins, attrs, ctx):
    """Levenshtein DP: a loop over the hypothesis tokens carrying one DP
    row; the insertions' left-to-right dependency is a prefix minimum
    (torch.cummin, the JAX rule's associative_scan of jnp.minimum)."""
    hyp_v, ref_v = ins['Hyps'][0], ins['Refs'][0]
    hyp = _ids2d(hyp_v)
    ref = _ids2d(ref_v)
    b_, th = hyp.shape
    tr = ref.shape[1]
    dev = hyp.device
    h_lens = _lengths(hyp_v, th)
    r_lens = _lengths(ref_v, tr)
    ignored = attrs.get('ignored_tokens') or []
    if ignored:
        hyp, h_lens = _strip_tokens(hyp, h_lens, ignored)
        ref, r_lens = _strip_tokens(ref, r_lens, ignored)

    row0 = torch.arange(tr + 1, dtype=torch.float32, device=dev)[None, :] \
        .expand(b_, tr + 1)
    shift = torch.arange(1, tr + 2, dtype=torch.float32, device=dev)[None, :]

    def step(row, xs):
        h_t, i = xs                                       # [B], scalar idx
        sub_cost = (ref != h_t[:, None]).to(torch.float32)
        ins_del_sub = torch.minimum(row[:, 1:] + 1.0,     # deletion
                                    row[:, :-1] + sub_cost)  # substitution
        first = row[:, :1] + 1.0                          # new_row[0] = i
        # the insertions: new[j] = min(cand[j], new[j-1] + 1)
        cand = torch.cat([first, ins_del_sub], dim=1)
        fixed = torch.cummin(cand - shift, dim=1).values + shift
        active = (i < h_lens)[:, None]
        return torch.where(active, fixed, row), ()

    row_n, _ = _loop(step, row0,
                     (_time_major(hyp), torch.arange(th, device=dev)), th)
    dist = torch.gather(row_n, 1, r_lens[:, None])[:, 0]
    if attrs.get('normalized', True):
        dist = dist / torch.clamp_min(r_lens, 1).to(torch.float32)
    return {'Out': dist[:, None],
            'SequenceNum': torch.full((), b_, dtype=torch.int64,
                                      device=dev)}


# ---------------------------------------------------------------------------
# chunk_eval
# ---------------------------------------------------------------------------

def _chunk_bounds(tags, lens, scheme, num_types, excluded):
    """Per-position (start, end, type, in_chunk) masks of a tag sequence.

    Tag encoding (reference chunk_eval_op.h): tag = type * tag_num + flag;
    the O tag is num_types * tag_num (or anything beyond)."""
    b_, t = tags.shape
    tag_num = {'plain': 1, 'IOB': 2, 'IOE': 2, 'IOBES': 4}[scheme]
    typ = torch.div(tags, tag_num, rounding_mode='floor')
    flag = torch.remainder(tags, tag_num)
    valid = torch.arange(t, device=tags.device)[None, :] < lens[:, None]
    non_o = valid & (typ < num_types)
    for ex in excluded:
        non_o = non_o & (typ != int(ex))

    minus1 = torch.full_like(tags[:, :1], -1)
    off = torch.zeros_like(non_o[:, :1])
    p_typ = torch.cat([minus1, typ[:, :-1]], 1)
    p_flag = torch.cat([minus1, flag[:, :-1]], 1)
    p_in = torch.cat([off, non_o[:, :-1]], 1)
    n_typ = torch.cat([typ[:, 1:], minus1], 1)
    n_flag = torch.cat([flag[:, 1:], minus1], 1)
    n_in = torch.cat([non_o[:, 1:], off], 1)
    n_valid = torch.cat([valid[:, 1:], off], 1)
    n_in = n_in & n_valid

    brk_prev = (~p_in) | (p_typ != typ)
    brk_next = (~n_in) | (n_typ != typ)
    if scheme == 'plain':
        start = non_o & brk_prev
        end = non_o & brk_next
    elif scheme == 'IOB':                                 # B=0, I=1
        start = non_o & ((flag == 0) | brk_prev)
        end = non_o & (brk_next | (n_flag == 0))
    elif scheme == 'IOE':                                 # I=0, E=1
        start = non_o & (brk_prev | (p_flag == 1))
        end = non_o & ((flag == 1) | brk_next)
    else:                                                 # IOBES: B,I,E,S
        start = non_o & ((flag == 0) | (flag == 3) | brk_prev
                         | (p_flag == 2) | (p_flag == 3))
        end = non_o & ((flag == 2) | (flag == 3) | brk_next
                       | (n_flag == 0) | (n_flag == 3))
    return start, end, typ, non_o


def _end_of_chunk_at(end, t):
    """e[t] = the index of the first end >= t (matches chunk extents): a
    suffix minimum, the flipped prefix minimum of the flipped row."""
    idx = torch.arange(t, device=end.device)[None, :].expand(end.shape)
    cand = torch.where(end, idx, torch.full_like(idx, t + 1))
    return torch.cummin(cand.flip(1), dim=1).values.flip(1)


@register('chunk_eval')
def _chunk_eval(ins, attrs, ctx):
    inf_v, lab_v = ins['Inference'][0], ins['Label'][0]
    inf = _ids2d(inf_v)
    lab = _ids2d(lab_v)
    b_, t = inf.shape
    lens = _lengths(lab_v, t)
    scheme = attrs.get('chunk_scheme', 'IOB')
    num_types = int(attrs['num_chunk_types'])
    excluded = attrs.get('excluded_chunk_types') or []

    s_i, e_i, t_i, _ = _chunk_bounds(inf, lens, scheme, num_types, excluded)
    s_l, e_l, t_l, _ = _chunk_bounds(lab, lens, scheme, num_types, excluded)
    ee_i = _end_of_chunk_at(e_i, t)
    ee_l = _end_of_chunk_at(e_l, t)

    n_inf = s_i.sum(dtype=torch.int64)
    n_lab = s_l.sum(dtype=torch.int64)
    correct = (s_i & s_l & (t_i == t_l) & (ee_i == ee_l)).sum(
        dtype=torch.int64)

    nc = correct.to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=inf.device)
    precision = torch.where(n_inf > 0, nc / torch.clamp_min(n_inf, 1), zero)
    recall = torch.where(n_lab > 0, nc / torch.clamp_min(n_lab, 1), zero)
    f1 = torch.where(nc > 0, 2 * precision * recall
                     / torch.clamp_min(precision + recall, 1e-12), zero)
    return {'Precision': precision.to(torch.float32),
            'Recall': recall.to(torch.float32),
            'F1-Score': f1.to(torch.float32),
            'NumInferChunks': n_inf, 'NumLabelChunks': n_lab,
            'NumCorrectChunks': correct}
