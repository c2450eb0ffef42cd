"""LoD beam search: the capacity form of the book's While-loop decoder, and
the step-form beam decode (one attention-LSTM beam step and the host-side
backtrace).

Parity: the JAX package's fluid/ops_impl/lod_beam.py. Its capacity form
(:35-298: is_beam_form, normalize_capacity, beam_search_step,
sequence_expand_beam, is_empty_beam, beam_search_decode_arrays) is the
second half of this module, with its own note. The step-form decode
(beam_init_carry :308, attention_beam_step :322, greedy_attend_cell :386,
backtrace_beams :420) is what the continuous-batching DecodeEngine
drives slot by slot through the decode-step rules of sampled_ops.py, and
what attention_lstm_beam_decode loops over the whole decode. Every row is
independent: no cross-row reduction mixes two sources, which is what lets
the engine pack unrelated slots into one step and mask the dead ones.

The joint top-k keeps lax.top_k's rule on ties, the lower index first: a
stable descending sort of the values' total-order keys (torch.topk
promises no order among equal values on the card). Ties at finfo(f32).min
are common: a finished beam offers one live candidate, so a slot whose
beams all finished has beam * V - beam candidates tied there.
"""
import numpy as np
import torch

from ...ops.kernels.paged_attention import attend as attend_rows
from ..lowering import SeqValue, data_of

__all__ = ['beam_init_carry', 'attention_beam_step', 'greedy_attend_cell',
           'backtrace_beams', 'top_k_lower_index', 'is_beam_form',
           'normalize_capacity', 'beam_search_step', 'sequence_expand_beam',
           'is_empty_beam', 'beam_search_decode_arrays']

NEG = float(torch.finfo(torch.float32).min)


def beam_init_carry(rows, beam, hidden, start_id, device=None,
                    dtype=torch.float32):
    """Fresh decode carry for `rows` sources at beam width `beam`, flat
    [rows*beam, ...] layout: zero LSTM state, start_id everywhere, and only
    beam 0 live in the accumulated scores so the first top-k does not pick
    `beam` copies of the same candidate."""
    n = rows * beam
    live = torch.arange(n, device=device) % beam == 0
    return (torch.zeros((n, hidden), dtype=dtype, device=device),
            torch.zeros((n, hidden), dtype=dtype, device=device),
            torch.full((n,), start_id, dtype=torch.int32, device=device),
            torch.where(live, 0.0, NEG).to(torch.float32),
            torch.zeros((n,), dtype=torch.bool, device=device))


# the signed integer views of the float dtypes the total-order key covers
_KEY_INTS = {torch.float32: (torch.int32, 31, 0x7fffffff),
             torch.bfloat16: (torch.int16, 15, 0x7fff),
             torch.float16: (torch.int16, 15, 0x7fff)}


def top_k_lower_index(x, k):
    """(values, indices) of the k largest entries of each row of x, equal
    values in index order (lax.top_k's rule). An fp32, bf16 or fp16 row is
    ordered as lax.top_k orders it, by the total order of its bit patterns
    (an integer view of the same width): +0.0 above -0.0 and NaN above
    +inf, where a float comparison ties the zeros."""
    key = x
    if x.dtype in _KEY_INTS:
        ity, sign, mag = _KEY_INTS[x.dtype]
        bits = x.view(ity)
        key = bits ^ ((bits >> sign) & mag)
    idx = torch.sort(key, dim=-1, descending=True, stable=True)[1][..., :k]
    return torch.gather(x, -1, idx), idx


def attention_beam_step(params, enc_t, mask_t, carry, beam, end_id,
                        attend=None):
    """One attend -> LSTM cell -> project -> joint top-k -> reorder beam
    step on flat [B*beam, ...] rows.

    params: (w_dec [E+D,4H], u_dec [H,4H], b_dec, w_q [H,D], w_emb [V,E],
    w_out [H,V], b_out); enc_t [B*beam, S, D] (source rows repeated per
    beam); mask_t [B*beam, S] 1/0; carry = (h, c, prev_ids, acc, fin) as
    built by beam_init_carry. Returns (carry', (sel_ids [B, beam], parent
    [B, beam] local beam index, top_scores [B, beam])).

    `attend`: optional q [Bb, D] -> ctx [Bb, D] override: the paged step
    passes the paged_attention kernel, which reads the encoder pages
    directly, with enc_t/mask_t None. None runs `attend_rows` on
    enc_t/mask_t, the function the paged kernel's plain version runs."""
    w_dec, u_dec, b_dec, w_q, w_emb, w_out, b_out = params
    hp, cp, prev_ids, acc, fin = carry
    Bb = hp.shape[0]
    B = Bb // beam
    V = w_out.shape[1]

    x_t = w_emb[prev_ids.long()]                      # [Bb, E]
    q = hp @ w_q
    ctx_vec = attend(q) if attend is not None else \
        attend_rows(q, enc_t, mask_t)
    g = torch.cat([x_t, ctx_vec], -1) @ w_dec + hp @ u_dec + b_dec
    gi, gf, gc, go = torch.chunk(g, 4, dim=-1)
    c_new = torch.sigmoid(gf) * cp + torch.sigmoid(gi) * torch.tanh(gc)
    h_new = torch.sigmoid(go) * torch.tanh(c_new)

    logp = torch.log_softmax((h_new @ w_out + b_out).to(torch.float32),
                             dim=-1)
    cand = acc[:, None] + logp                        # [Bb, V]
    # finished beams: a single end_id candidate carrying the score forward
    onehot_end = torch.arange(V, device=cand.device)[None, :] == end_id
    cand = torch.where(fin[:, None],
                       torch.where(onehot_end, acc[:, None], NEG), cand)

    flat = cand.reshape(B, beam * V)
    top_scores, top_pos = top_k_lower_index(flat, beam)   # [B, beam]
    parent = torch.div(top_pos, V, rounding_mode='floor')
    sel_ids = (top_pos - parent * V).to(torch.int32)
    gidx = (parent + beam * torch.arange(B, device=cand.device)[:, None]
            ).reshape(Bb)

    h_new = h_new[gidx]
    c_new = c_new[gidx]
    new_ids = sel_ids.reshape(Bb)
    new_acc = top_scores.reshape(Bb)
    new_fin = fin[gidx] | (new_ids == end_id)
    return (h_new, c_new, new_ids, new_acc, new_fin), \
        (sel_ids, parent.to(torch.int32), top_scores)


def greedy_attend_cell(params, enc, mask, h, c, tok, attend=None):
    """One attend -> LSTM cell -> project step for [B] independent rows
    with no beam dimension: the draft's proposal step of speculative
    decoding (sampled_ops.attention_lstm_spec_decode_step), the cell math
    of attention_beam_step at beam 1 without the top-k and reorder.

    params: the WEIGHT_KEYS tuple; enc [B, S, D]; mask [B, S] 1/0; h, c
    [B, H]; tok [B] int. Returns (h2, c2, logits [B, V] float32).
    `attend`: optional q [B, D] -> ctx [B, D] override (see
    attention_beam_step); with it set, enc and mask may be None."""
    w_dec, u_dec, b_dec, w_q, w_emb, w_out, b_out = params
    x = w_emb[tok.long()]
    q = h @ w_q
    ctx_vec = attend(q) if attend is not None else attend_rows(q, enc, mask)
    g = torch.cat([x, ctx_vec], -1) @ w_dec + h @ u_dec + b_dec
    gi, gf, gc, go = torch.chunk(g, 4, dim=-1)
    c2 = torch.sigmoid(gf) * c + torch.sigmoid(gi) * torch.tanh(gc)
    h2 = torch.sigmoid(go) * torch.tanh(c2)
    return h2, c2, (h2 @ w_out + b_out).to(torch.float32)


def backtrace_beams(ids_seq, par_seq):
    """Host-side backtrace of one source's per-step beams (numpy), run per
    slot by the engine when the slot releases.

    ids_seq/par_seq: [L, beam] selected token / local parent per step.
    Returns the int token matrix [beam, L] in forward order. Steps past
    the point where every beam finished contribute end_id tokens and
    identity parents in the whole-sequence decode, so truncating at
    release and padding with end_id gives its output."""
    ids_seq = np.asarray(ids_seq)
    par_seq = np.asarray(par_seq)
    L, beam = ids_seq.shape
    ptr = np.arange(beam)
    toks = np.empty((L, beam), ids_seq.dtype)
    for t in range(L - 1, -1, -1):
        toks[t] = ids_seq[t][ptr]
        ptr = par_seq[t][ptr]
    return toks.T


# ---------------------------------------------------------------------------
# the capacity form: the book's While-loop LoD beam decoder (the JAX :35-298)
# ---------------------------------------------------------------------------
#
# Reference operators/beam_search_op.cc (SelectTopBeamSizeItems / ToMap /
# PruneEndBeams) and operators/beam_search_decode_op.h (Backtrace +
# ConvertSentenceVectorToLodTensor), driven by the book's
# test_machine_translation.py decode_main. There the number of live beam
# rows per source changes every While iteration and lives in the 2-level
# LoD of selected_ids / selected_scores. A captured graph needs static
# shapes, so these functions run the same algorithm at a fixed CAPACITY:
#
#   - every step tensor is a SeqValue with data [B*K, ...]: source s owns
#     the row block [s*K, (s+1)*K), its live rows compacted to the front;
#   - `lengths` (int64 [B*K]) is the reference's lod[1] at capacity:
#     entry s*K + p is the number of selected children of parent group p
#     (a row of the PREVIOUS step); dead slots hold 0;
#   - `outer_lengths[0]` (int64 [B]) is lod[0]: parent groups a source.
#
# The While rule's capacity-widening pass (block_ops._widen_carry_to_body)
# makes the form from the narrower pre-loop feeds; the beam_search,
# sequence_expand, lod_reset, lookup_table and is_empty rules consume and
# emit it; beam_search_decode backtraces the arrays as the reference's host
# walk does, on the device. No rule reads a length on the host.

NEG_CAP = -1e30


def is_beam_form(v):
    """A capacity-form 2-level SeqValue, told by the explicit beam_cap flag
    that only normalize_capacity, the While widening pass and the beam
    rules set (so ordinary 2-level data whose shapes look capacity-like
    is never routed here). The structural conditions stay as an AND: a
    flag on a value that cannot be capacity form falls through to the
    ordinary path."""
    return bool(isinstance(v, SeqValue) and v.beam_cap and v.outer_lengths
                and v.outer_lengths[0].shape[0] != v.data.shape[0]
                and v.data.shape[0] % v.outer_lengths[0].shape[0] == 0)


def blocks(v):
    """(B, K) of a capacity-form SeqValue."""
    b = v.outer_lengths[0].shape[0]
    return b, v.data.shape[0] // b


def rows_live(v):
    """[B] live rows a source block: the sum of its lod[1] lengths."""
    b, k = blocks(v)
    return v.lengths.reshape(b, k).sum(dim=1)


def _compact_order(sel, key):
    """Per-source compaction: the stable argsort putting the selected
    entries first, in `key` order. sel [B, N]; key broadcasts to it.
    Returns indices [B, N]."""
    n = sel.shape[1]
    rank = torch.where(sel, key, n * n + key)
    return torch.argsort(rank, dim=1, stable=True)


def _rows_per_source_narrow(v):
    """Rows a source of a NARROW (pre-capacity) 2-level SeqValue: level-0
    lengths count level-1 groups, and in the decode idiom each group is
    one row (data [rows, 1, ...] or [rows, ...])."""
    return v.outer_lengths[0].long()


def normalize_capacity(pre_ids, pre_scores, ids, scores, beam_size):
    """A beam step's inputs in capacity form [B*K, ...].

    The While widening pass normally does this before the loop runs; this
    in-rule path serves the pass's own shape run (its first run of the
    body sees the narrow pre-loop shapes) and direct calls on feed-shaped
    values."""
    if is_beam_form(pre_scores):
        return pre_ids, pre_scores, data_of(ids), data_of(scores)
    B = pre_scores.outer_lengths[0].shape[0]
    K = int(beam_size)
    rows = _rows_per_source_narrow(pre_scores)
    n_rows = data_of(pre_scores).shape[0]
    dev = rows.device
    # each narrow row's source and its position within the source block
    ends = torch.cumsum(rows, 0)
    r = torch.arange(n_rows, device=dev)
    src = torch.clamp(torch.searchsorted(ends, r, right=True), max=B - 1)
    pos = r - torch.where(src > 0, ends[src - 1], 0)
    dest = src * K + pos                                 # [n_rows]

    def scatter(flat, fill=0):
        flat = data_of(flat)
        if flat.ndim > 2 and flat.shape[1] == 1:
            flat = flat[:, 0]                            # the pad-time dim
        out = torch.full((B * K,) + tuple(flat.shape[1:]), fill,
                         dtype=flat.dtype, device=flat.device)
        return out.index_copy(0, dest, flat)

    l1 = torch.zeros((B * K,), dtype=torch.int64, device=dev).index_fill(
        0, dest, 1)

    def mk(v):
        return SeqValue(scatter(v), l1, (rows,), beam_cap=True)

    return mk(pre_ids), mk(pre_scores), scatter(ids), scatter(scores)


def beam_search_step(pre_ids, pre_scores, ids, scores, beam_size, end_id):
    """One reference beam_search step on capacity-form values.

    pre_ids / pre_scores: SeqValue [B*K, 1]; ids / scores: [B*K, topk]
    dense. Returns (selected_ids SeqValue, selected_scores SeqValue,
    parent_rows int64 [B*K]: the global parent row of each output row,
    -1 where dead)."""
    K = int(beam_size)
    B, Kcap = blocks(pre_scores)
    R = B * Kcap
    pid = data_of(pre_ids).reshape(R).long()
    psc = data_of(pre_scores).reshape(R).to(torch.float32)
    cid = data_of(ids).reshape(R, -1).long()
    csc = data_of(scores).reshape(R, -1).to(torch.float32)
    topk = cid.shape[1]
    dev = psc.device

    live = ((torch.arange(R, device=dev) % Kcap).reshape(B, Kcap)
            < rows_live(pre_scores)[:, None]).reshape(R)
    ended = live & (pid == end_id)

    # the candidate table [R, topk]: an ended row offers ONE candidate
    # (end_id, its pre_score) in slot 0 (reference NextItemSet); a dead
    # row offers none
    slot0 = torch.arange(topk, device=dev)[None, :] == 0
    cand_sc = torch.where(ended[:, None],
                          torch.where(slot0, psc[:, None], NEG_CAP), csc)
    cand_id = torch.where(ended[:, None], end_id, cid)
    cand_sc = torch.where(live[:, None], cand_sc, NEG_CAP)

    # the top beam_size a SOURCE over its Kcap * topk candidates
    flat_sc = cand_sc.reshape(B, Kcap * topk)
    top_sc, top_pos = top_k_lower_index(flat_sc, K)      # [B, K]
    sel_valid = top_sc > NEG_CAP / 2
    # PruneEndBeams: a source whose live rows have all ended selects only
    # end repeats and emits nothing further
    finished = (rows_live(pre_scores) > 0) & \
        (~live | ended).reshape(B, Kcap).all(dim=1)
    sel_valid = sel_valid & ~finished[:, None]

    # the output rows grouped by parent row ascending, then candidate slot
    # ascending (the reference writes items per offset in encounter order)
    sel_mask = torch.zeros((B, Kcap * topk), dtype=torch.bool, device=dev)
    sel_mask = sel_mask.scatter(1, top_pos, sel_valid)
    order = _compact_order(sel_mask,
                           torch.arange(Kcap * topk, device=dev)[None, :])
    ordered_pos = order[:, :Kcap]                        # [B, Kcap]
    ordered_ok = torch.gather(sel_mask, 1, ordered_pos)
    parent_local = torch.div(ordered_pos, topk, rounding_mode='floor')
    out_id = torch.gather(cand_id.reshape(B, Kcap * topk), 1, ordered_pos)
    out_sc = torch.gather(cand_sc.reshape(B, Kcap * topk), 1, ordered_pos)
    out_id = torch.where(ordered_ok, out_id, 0)
    out_sc = torch.where(ordered_ok, out_sc, 0.0)

    # lod[1]: children a parent slot; lod[0]: parent groups a source (the
    # input's live rows: the reference copies the high level verbatim)
    l1 = torch.zeros((B, Kcap), dtype=torch.int64, device=dev).scatter_add(
        1, parent_local, ordered_ok.long())
    l0 = rows_live(pre_scores).long()

    parent_rows = torch.where(
        ordered_ok,
        parent_local + (torch.arange(B, device=dev) * Kcap)[:, None], -1)
    sel_ids = SeqValue(out_id.reshape(R, 1), l1.reshape(R), (l0,),
                       beam_cap=True)
    sel_scores = SeqValue(out_sc.reshape(R, 1), l1.reshape(R), (l0,),
                          beam_cap=True)
    return sel_ids, sel_scores, parent_rows.reshape(R)


def sequence_expand_beam(x, y):
    """x's row for parent group p of source s sits at x.data[s*K + p] (the
    previous step's children ARE this step's parent groups); output row
    (s, child c) copies x[parent_of(c)] (reference sequence_expand over
    the 2-level LoD)."""
    B, Kcap = blocks(y)
    xd = data_of(x)
    if xd.ndim > 2 and xd.shape[1] == 1:
        xd = xd[:, 0]
    dev = y.lengths.device
    # child rows are compacted per source in parent order, so a child's
    # parent is searchsorted(cumsum(l1), c, right)
    l1 = y.lengths.reshape(B, Kcap)
    ends = torch.cumsum(l1, dim=1)                       # [B, Kcap]
    child = torch.arange(Kcap, device=dev)[None, :].expand(B, Kcap)
    parent = torch.clamp(
        torch.searchsorted(ends, child.contiguous(), right=True),
        max=Kcap - 1)
    rows = parent + torch.arange(B, device=dev)[:, None] * Kcap
    out = xd[rows.reshape(-1)]
    # [rows, 1, ...]: each output row is a one-token level-1 group, and
    # the fc ops downstream were shape-inferred for the padded 3-D layout
    return SeqValue(out[:, None], y.lengths, y.outer_lengths,
                    beam_cap=True)


def is_empty_beam(v):
    """0-d bool: every source pruned (no live row)."""
    return (rows_live(v).sum() == 0).reshape(())


def beam_search_decode_arrays(ids_arr, scores_arr, beam_size, end_id):
    """Backtrace the step arrays into sentences (reference Backtrace +
    ConvertSentenceVectorToLodTensor with reverse=true and
    sort_by_score=true, the op's defaults: the hypotheses of a source
    ordered by accumulated score).

    Returns (sentence_ids SeqValue [B*K, T_cap] int64, sentence_scores
    SeqValue of the same shape, float32): lengths are the tokens a
    hypothesis, outer the hypotheses a source. Only the hypotheses alive
    at the seed step are emitted (the reference pads a pruned source to
    beam_size empty sentences)."""
    data_ids = ids_arr.buffer[0]             # [T_cap, R, 1]
    lens = ids_arr.buffer[1]                 # [T_cap, R]
    data_sc = scores_arr.buffer[0]
    T_cap, R = lens.shape
    n_src = ids_arr.buffer[2].shape[1]
    B, Kcap = n_src, R // n_src
    T_live = ids_arr.length                  # a device scalar
    dev = lens.device

    l1 = lens.reshape(T_cap, B, Kcap)
    child_cnt = l1.sum(dim=2)                # [T_cap, B] live children
    steps = torch.arange(T_cap, device=dev)
    step_ok = (steps[:, None] < T_live) & (child_cnt > 0)
    # the seed step of a source: the LAST step with any children (a source
    # finished and pruned earlier seeds at its own last nonempty step)
    t_seed = torch.where(step_ok, steps[:, None], -1).amax(dim=0)  # [B]
    ends = torch.cumsum(l1, dim=2)           # [T_cap, B, Kcap]

    n_hyp = torch.gather(child_cnt, 0, torch.clamp(t_seed, min=0)[None, :])[0]
    n_hyp = torch.clamp(n_hyp, max=Kcap)
    hyp = torch.arange(Kcap, device=dev)[None, :].expand(B, Kcap)
    base = (torch.arange(B, device=dev) * Kcap)[:, None]

    ptr = torch.zeros((B, Kcap), dtype=torch.int64, device=dev)
    started = torch.zeros((B, Kcap), dtype=torch.bool, device=dev)
    toks, scs, valids = [], [], []
    for t in range(T_cap - 1, -1, -1):
        start_now = (t_seed == t)[:, None] & (hyp < n_hyp[:, None])
        ptr = torch.where(start_now, hyp, ptr)
        started = started | start_now
        gidx = (base + ptr).reshape(-1)
        toks.append(data_ids[t].reshape(R)[gidx].reshape(B, Kcap))
        scs.append(data_sc[t].reshape(R)[gidx].reshape(B, Kcap))
        valids.append(started)
        parent = torch.clamp(torch.searchsorted(ends[t], ptr, right=True),
                             max=Kcap - 1)
        ptr = torch.where(started, parent, ptr)
    toks = torch.stack(toks)                 # [T_cap, B, K], seed first
    scs = torch.stack(scs)
    valids = torch.stack(valids)

    # skip redundant end tokens: an end_id is dropped unless it is the
    # first (seed-position) token of the hypothesis
    first = torch.cumsum(valids.long(), dim=0) == 1
    keep = valids & (first | (toks != end_id))

    # forward order, each hypothesis compacted to the left
    def flat(a):
        return a.permute(1, 2, 0).reshape(B * Kcap, T_cap)

    back = torch.arange(T_cap, device=dev)
    kp = flat(keep)
    order = torch.argsort(torch.where(kp, -back[None, :], T_cap), dim=1,
                          stable=True)
    tok_f = torch.gather(flat(toks), 1, order)
    sc_f = torch.gather(flat(scs), 1, order)
    nt = kp.sum(dim=1)
    hyp_valid = (hyp < n_hyp[:, None]).reshape(-1)
    nt = torch.where(hyp_valid, nt, 0)

    # sort_by_score: a source's hypotheses by their accumulated score (the
    # seed step's, since beam scores accumulate), descending; ties keep
    # the beam-slot order (a stable argsort)
    seed_sc = (scs * first.to(scs.dtype)).sum(dim=0)     # [B, Kcap]
    seed_key = torch.where(hyp < n_hyp[:, None], -seed_sc, float('inf'))
    perm = torch.argsort(seed_key, dim=1, stable=True)
    rows = (base + perm).reshape(-1)
    tok_f, sc_f, nt = tok_f[rows], sc_f[rows], nt[rows]

    sent_ids = SeqValue(tok_f.long(), nt, (n_hyp.long(),), beam_cap=True)
    sent_scores = SeqValue(sc_f.to(torch.float32), nt, (n_hyp.long(),),
                           beam_cap=True)
    return sent_ids, sent_scores
