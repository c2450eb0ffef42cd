"""Beam and speculative decode rules: the whole-sequence beam decode of the
generating program and the step rules of the continuous-batching
DecodeEngine.

Parity: the JAX package's fluid/ops_impl/sampled_ops.py, its decode rules:
`attention_lstm_beam_decode` (the whole beam search, :156), the two
step-form beam rules the engine drives, `attention_lstm_beam_decode_step`
(dense slot buffers, :221) and `attention_lstm_beam_paged_step` (page
pools, :393), and the speculative step `attention_lstm_spec_decode_step`
(:491), with their helpers `_masked_beam_advance` :326,
`_decode_weight_params` :347 and `_paged_hist_write` :379. The beam rules
share lod_beam.attention_beam_step, so the engine's results equal the
whole-sequence decode's and the paged engine matches the dense one by
construction. `_gather_paged_enc` :361 serves only the JAX rules'
kernel-off branch; here its gather is paged_attention's plain version.
`beam_search` (:100) and `beam_search_decode` (:692), in their dense and
their LoD (capacity) forms, close the module; before them the two sampled
losses, `nce` (:23) and `hierarchical_sigmoid` (:63).

`nce` draws its shared negatives uniformly on the device from
ctx.generator (the generator each captured step registers, so every
replay draws afresh) and hands them to `nce_cost`, a function of the
drawn negatives that the tests hold against the JAX rule on the same
negatives: the two packages' draws differ, their law is the same.
`hierarchical_sigmoid` walks the complete binary tree as the JAX rule
does, a static [B, max_depth] gather of heap ancestors with a masked
logistic loss.

The paged and the speculative rules call `ops.kernels.paged_attention`
unconditionally: on the card that launches the CUDA kernel, on the CPU its
plain version. There is no switch (the JAX package's PADDLE_TPU_KERNELS
knob has no counterpart). The speculative step attends at beam 1: R =
spec_k + 1 launches for its verify scan, and R more for a weights draft.

The JAX lax.scans are Python loops here: `max_len` steps of the whole
decode (one on `meta` tensors, build-time inference, as
sequence_ops._scan does), `bundle` steps of a step rule, R draft and R
verify steps of the speculative one. Slots that finish mid-bundle freeze,
so results equal bundle=1. Nothing here reads a value back to the host,
so every rule runs inside a captured CUDA graph.

Torch has no `mode='drop'` scatter. The history write redirects invalid
rows to a scratch row appended past the pool and drops it: two live slots
never share a history page, so every kept row has exactly one writer and
the result does not depend on the order `index_put_` applies duplicate
indices in (only the dropped rows collide, on the scratch row).
"""
import math

import torch

from ...ops.kernels import paged_attention
from ..lowering import register, data_of, SeqValue
from .math_ops import _clip
from .tensor_ops import take_rows
from .lod_beam import (attention_beam_step, beam_init_carry,
                       greedy_attend_cell)


def _masked_beam_advance(params, enc_t, mask_t, carry5, active, beam,
                         end_id, attend=None):
    """One beam step over the slot pool with where-select masking: only
    ACTIVE slots advance; every other row keeps its old state bit for
    bit, so joins, leaves and slots that finished earlier in a bundle
    never disturb live ones."""
    h, c, prev, acc, fin = carry5
    new_carry, (sel_ids, parent, _top) = attention_beam_step(
        params, enc_t, mask_t, carry5, beam, end_id, attend=attend)
    act_row = active.repeat_interleave(beam)           # [slots*beam]

    def sel(new, old):
        return torch.where(act_row.reshape((-1,) + (1,) * (new.dim() - 1)),
                           new, old)

    return (sel(new_carry[0], h), sel(new_carry[1], c),
            sel(new_carry[2], prev), sel(new_carry[3], acc),
            sel(new_carry[4], fin)), (sel_ids, parent)


def _decode_weight_params(ins, prefix=''):
    """The WEIGHT_KEYS tuple (w_dec, u_dec, b_dec, w_q, w_emb, w_out,
    b_out) from op inputs; a missing bias is 0. prefix='Draft' reads the
    draft's tensors of the speculative step."""
    def get(slot):
        return data_of(ins[prefix + slot][0]) if ins.get(prefix + slot) \
            else 0.0

    return (get('WDec'), get('UDec'), get('BDec'), get('WAttnQ'),
            get('WEmb'), get('WOut'), get('BOut'))


@register('attention_lstm_beam_decode')
def _attention_lstm_beam_decode(ins, attrs, ctx):
    """The whole beam search of the generating program (the JAX rule :156;
    the reference book test_machine_translation.py:decode()): max_len
    calls of lod_beam.attention_beam_step from beam_init_carry, then the
    backtrace over the stacked ids and parents, all on the device.

    Inputs: EncOut [B, S, D] (a SeqValue: its lengths mask the attention),
    WDec [E+D, 4H], UDec [H, 4H], BDec [1, 4H], WAttnQ [H, D], WEmb [V, E],
    WOut [H, V], BOut [1, V]. Attrs: beam_size, max_len, start_id, end_id.
    Outputs: SentenceIds int64 [B, beam, max_len], SentenceScores float32
    [B, beam]."""
    enc = ins['EncOut'][0]
    enc_data = data_of(enc)
    B, S, _ = enc_data.shape
    enc_mask = enc.mask(torch.float32) if isinstance(enc, SeqValue) else \
        torch.ones((B, S), dtype=torch.float32, device=enc_data.device)
    params = _decode_weight_params(ins)
    beam = int(attrs['beam_size'])
    max_len = int(attrs['max_len'])
    end_id = int(attrs['end_id'])
    enc_t = enc_data.repeat_interleave(beam, dim=0)     # [B*beam, S, D]
    mask_t = enc_mask.repeat_interleave(beam, dim=0)
    carry = beam_init_carry(B, beam, params[1].shape[0],
                            int(attrs.get('start_id', 0)),
                            device=enc_data.device, dtype=enc_data.dtype)
    meta = enc_data.device.type == 'meta'
    ids, parents = [], []
    for _ in range(1 if meta else max_len):
        carry, (sel_ids, parent, _top) = attention_beam_step(
            params, enc_t, mask_t, carry, beam, end_id)
        ids.append(sel_ids)
        parents.append(parent.long())
    scores = carry[3].reshape(B, beam)
    if meta:
        sent = ids[0].unsqueeze(-1).expand(B, beam, max_len)
        return {'SentenceIds': sent.long(), 'SentenceScores': scores}
    # the backtrace (the JAX `back` scan): each final beam's pointer walks
    # its parents from the last step to the first
    ptr = torch.arange(beam, device=enc_data.device).expand(B, beam)
    toks = [None] * max_len
    for t in range(max_len - 1, -1, -1):
        toks[t] = torch.gather(ids[t], 1, ptr)
        ptr = torch.gather(parents[t], 1, ptr)
    return {'SentenceIds': torch.stack(toks, dim=-1).long(),
            'SentenceScores': scores}


def _paged_hist_write(pool, pt_hist, step, page_size, valid, rows):
    """Write one [slots, beam] history row into the page pool at each
    slot's own (page, offset): physical page = pt_hist[slot,
    step // page_size], offset = step % page_size. Invalid slots, and
    table entries past the pool (the engine's unassigned sentinel), are
    dropped, as the JAX rule's mode='drop' scatter drops them."""
    n_pages = pool.shape[0]
    lp = torch.div(step, page_size, rounding_mode='floor')         # [C]
    # an inactive slot's step may sit one page past its table: clamp the
    # lookup (its write is dropped anyway)
    lp_c = lp.clamp(max=pt_hist.shape[1] - 1).long()
    phys = pt_hist.gather(1, lp_c[:, None])[:, 0].long()
    keep = valid & (phys >= 0) & (phys < n_pages)
    n_rows = n_pages * page_size
    flat = phys * page_size + (step - lp * page_size).long()
    flat = torch.where(keep, flat, n_rows)                   # scratch row
    buf = torch.cat([pool.reshape((n_rows,) + pool.shape[2:]),
                     pool.new_zeros((1,) + pool.shape[2:])])
    buf.index_put_((flat,), rows.to(pool.dtype))
    return buf[:n_rows].reshape(pool.shape)


def _state(ins):
    """The slot state both step rules read, in its working dtypes."""
    return (data_of(ins['H'][0]), data_of(ins['C'][0]),
            data_of(ins['PrevIds'][0]).to(torch.int32),
            data_of(ins['Acc'][0]).to(torch.float32),
            data_of(ins['Fin'][0]).to(torch.bool),
            data_of(ins['Step'][0]).to(torch.int32),
            data_of(ins['Limit'][0]).to(torch.int32),
            data_of(ins['Active'][0]).to(torch.bool))


def _run_bundle(one_step, h, c, prev_ids, acc, fin, hist, step, active_in,
                bundle):
    """Drive `one_step` bundle times over the flat carry; returns the
    final carry with the accumulated Bad flags."""
    slots, beam = prev_ids.shape
    flat = lambda a: a.reshape((slots * beam,) + a.shape[2:])
    carry = (flat(h), flat(c), flat(prev_ids), flat(acc), flat(fin), hist,
             step, active_in, torch.zeros_like(active_in))
    for _ in range(bundle):
        carry = one_step(carry)
    return carry


def _step_outputs(carry, active_in, slots, beam, hist_names):
    h2, c2, ids2, acc2, fin2, (hist_a, hist_b), step2, active2, bad = carry
    unflat = lambda a: a.reshape((slots, beam) + a.shape[1:])
    return {'HOut': unflat(h2), 'COut': unflat(c2),
            'PrevIdsOut': unflat(ids2), 'AccOut': unflat(acc2),
            'FinOut': unflat(fin2), hist_names[0]: hist_a,
            hist_names[1]: hist_b, 'StepOut': step2,
            'ActiveOut': active2, 'Done': active_in & ~active2,
            'Bad': bad}


def _advance_flags(acc2, fin2, step, active, limit, bad_acc, slots, beam):
    """The step counter, the still-active mask and the Bad flags after one
    step: a slot is done when all its beams ended, its limit is hit or its
    scores went NaN."""
    step2 = step + active.to(torch.int32)
    acc_s = acc2.reshape(slots, beam)
    fin_s = fin2.reshape(slots, beam)
    bad_t = active & torch.isnan(acc_s).any(dim=1)
    done_t = active & (fin_s.all(dim=1) | (step2 >= limit) | bad_t)
    return step2, active & ~done_t, bad_acc | bad_t


@register('attention_lstm_beam_decode_step')
def _attention_lstm_beam_decode_step(ins, attrs, ctx):
    """A bundle of decode steps over a fixed pool of independent SLOTS
    with dense per-slot buffers (the JAX rule :221).

    State (written): H, C [slots, beam, hidden]; PrevIds [slots, beam]
    int32; Acc [slots, beam] f32; Fin [slots, beam] bool; IdsHist, ParHist
    [slots, max_len, beam] int32; Step [slots] int32; Active [slots] bool.
    Read-only: Enc [slots, src_cap, D], Mask [slots, src_cap], Limit
    [slots] int32, the weights. Outputs also Done [slots] (finished
    within this bundle) and Bad [slots] (NaN in the slot's scores)."""
    h, c, prev_ids, acc, fin, step, limit, active_in = _state(ins)
    enc = data_of(ins['Enc'][0])
    mask = data_of(ins['Mask'][0])
    ids_hist = data_of(ins['IdsHist'][0]).to(torch.int32)
    par_hist = data_of(ins['ParHist'][0]).to(torch.int32)
    params = _decode_weight_params(ins)
    slots, beam = prev_ids.shape
    t_cap = ids_hist.shape[1]
    end_id = int(attrs['end_id'])
    enc_t = enc.repeat_interleave(beam, dim=0)        # [slots*beam, S, D]
    mask_t = mask.repeat_interleave(beam, dim=0)
    t_idx = torch.arange(t_cap, device=step.device)[None, :]

    def one_step(carry):
        h, c, prev, acc, fin, (ids_h, par_h), step, active, bad = carry
        (h2, c2, ids2, acc2, fin2), (sel_ids, parent) = \
            _masked_beam_advance(params, enc_t, mask_t,
                                 (h, c, prev, acc, fin), active, beam,
                                 end_id)
        # per-slot history write at each slot's OWN step index
        at_t = ((t_idx == step[:, None]) & active[:, None])[:, :, None]
        ids_h2 = torch.where(at_t, sel_ids[:, None, :], ids_h)
        par_h2 = torch.where(at_t, parent[:, None, :], par_h)
        step2, active2, bad2 = _advance_flags(acc2, fin2, step, active,
                                              limit, bad, slots, beam)
        return (h2, c2, ids2, acc2, fin2, (ids_h2, par_h2), step2, active2,
                bad2)

    carry = _run_bundle(one_step, h, c, prev_ids, acc, fin,
                        (ids_hist, par_hist), step, active_in,
                        int(attrs.get('bundle', 1)))
    return _step_outputs(carry, active_in, slots, beam,
                         ('IdsHistOut', 'ParHistOut'))


@register('attention_lstm_beam_paged_step')
def _attention_lstm_beam_paged_step(ins, attrs, ctx):
    """The paged-memory form of `attention_lstm_beam_decode_step` (the JAX
    rule :393): token history and encoder rows live in PAGES of pool
    inputs, indexed through per-slot int32 page tables. The attention
    reads the encoder pools through the tables (paged_attention); history
    tokens go to (pt_hist[slot, step // page_size], step % page_size),
    inactive rows dropped.

    State (written): H, C, PrevIds, Acc, Fin, Step, Active as the dense
    rule; HistIds/HistPar [pages, page_size, beam] int32 pools.
    Read-only: PtHist [slots, ceil(max_len/page_size)], PtEnc [slots,
    ceil(src_cap/page_size)], EncPages [enc_pages, page_size, D],
    MaskPages [enc_pages, page_size], Limit, the weights.
    Attrs: beam_size, end_id, bundle, page_size, src_cap."""
    h, c, prev_ids, acc, fin, step, limit, active_in = _state(ins)
    pt_hist = data_of(ins['PtHist'][0]).to(torch.int32)
    pt_enc = data_of(ins['PtEnc'][0]).to(torch.int32)
    enc_pages = data_of(ins['EncPages'][0])
    mask_pages = data_of(ins['MaskPages'][0])
    hist_ids = data_of(ins['HistIds'][0])
    hist_par = data_of(ins['HistPar'][0])
    params = _decode_weight_params(ins)
    slots, beam = prev_ids.shape
    page_size = int(attrs['page_size'])
    end_id = int(attrs['end_id'])
    src_cap = int(attrs['src_cap'])

    def attend(q):
        return paged_attention(q, enc_pages, mask_pages, pt_enc, src_cap)

    def one_step(carry):
        h, c, prev, acc, fin, (ids_pool, par_pool), step, active, bad = \
            carry
        (h2, c2, ids2, acc2, fin2), (sel_ids, parent) = \
            _masked_beam_advance(params, None, None,
                                 (h, c, prev, acc, fin), active, beam,
                                 end_id, attend=attend)
        ids_pool2 = _paged_hist_write(ids_pool, pt_hist, step, page_size,
                                      active, sel_ids)
        par_pool2 = _paged_hist_write(par_pool, pt_hist, step, page_size,
                                      active, parent)
        step2, active2, bad2 = _advance_flags(acc2, fin2, step, active,
                                              limit, bad, slots, beam)
        return (h2, c2, ids2, acc2, fin2, (ids_pool2, par_pool2), step2,
                active2, bad2)

    carry = _run_bundle(one_step, h, c, prev_ids, acc, fin,
                        (hist_ids, hist_par), step, active_in,
                        int(attrs.get('bundle', 1)))
    return _step_outputs(carry, active_in, slots, beam,
                         ('HistIdsOut', 'HistParOut'))


@register('attention_lstm_spec_decode_step')
def _attention_lstm_spec_decode_step(ins, attrs, ctx):
    """Speculative greedy decoding over the paged slot pool (the JAX rule
    :491): a draft proposes spec_k tokens, the target verifies them all in
    one dispatch, and accept and rollback are where-selects on the device.

    The emitted token at every position is the target's own greedy argmax;
    the draft only decides how many positions are valid. Position t is
    emitted iff every earlier proposal matched, no earlier token was
    end_id and the slot is live and within its limit there, so a slot
    emits 1 to spec_k + 1 tokens a dispatch. The verify phase batches what
    does not depend on the recurrence: the embedding and x @ w_dec[:E]
    over the R = spec_k + 1 positions before its scan, and the output
    projection, log-softmax and argmax after it; the scan keeps the
    attention, ctx @ w_dec[E:], h @ u_dec and the cell.

    Draft forms (attr `draft`): 'weights', a small attention-LSTM of its
    own Draft* weights (the target's vocab and encoder width) whose state
    rides in DraftH/DraftC [slots, draft_hidden]; 'table', a [V] int32
    next-token table (DraftTable), no state.

    State as the paged beam rule at beam 1. Attrs: end_id, spec_k,
    page_size, src_cap, draft. Outputs also Accepted [slots] int32, the
    proposals accepted this dispatch. Every attend (the draft's and the
    verify scan's) is the paged_attention kernel on the card."""
    h = data_of(ins['H'][0])[:, 0]                      # [C, H]
    c = data_of(ins['C'][0])[:, 0]
    prev = data_of(ins['PrevIds'][0]).to(torch.int32)[:, 0]
    acc = data_of(ins['Acc'][0]).to(torch.float32)[:, 0]
    fin = data_of(ins['Fin'][0]).to(torch.bool)[:, 0]
    step = data_of(ins['Step'][0]).to(torch.int32)
    limit = data_of(ins['Limit'][0]).to(torch.int32)
    active = data_of(ins['Active'][0]).to(torch.bool)
    pt_hist = data_of(ins['PtHist'][0]).to(torch.int32)
    pt_enc = data_of(ins['PtEnc'][0]).to(torch.int32)
    enc_pages = data_of(ins['EncPages'][0])
    mask_pages = data_of(ins['MaskPages'][0])
    hist_ids = data_of(ins['HistIds'][0])
    hist_par = data_of(ins['HistPar'][0])
    w_dec, u_dec, b_dec, w_q, w_emb, w_out, b_out = \
        _decode_weight_params(ins)
    C = prev.shape[0]
    page_size = int(attrs['page_size'])
    end_id = int(attrs['end_id'])
    src_cap = int(attrs['src_cap'])
    R = int(attrs['spec_k']) + 1         # verify steps = proposals + 1
    E = w_emb.shape[1]

    def attend(q):
        return paged_attention(q, enc_pages, mask_pages, pt_enc, src_cap)

    # -- draft phase: R proposals, so the draft state can roll back to any
    # accepted position
    hd_seq = cd_seq = None
    if attrs.get('draft', 'weights') == 'table':
        table = data_of(ins['DraftTable'][0]).long()
        d_list, tok = [], prev
        for _ in range(R):
            tok = table[tok.long()].to(torch.int32)
            d_list.append(tok)
    else:
        dparams = _decode_weight_params(ins, prefix='Draft')
        hd, cd, tok = (data_of(ins['DraftH'][0]), data_of(ins['DraftC'][0]),
                       prev)
        d_list, hd_list, cd_list = [], [], []
        for _ in range(R):
            hd, cd, logits = greedy_attend_cell(dparams, None, None, hd, cd,
                                                tok, attend=attend)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            d_list.append(tok)
            hd_list.append(hd)
            cd_list.append(cd)
        hd_seq, cd_seq = torch.stack(hd_list), torch.stack(cd_list)
    d_seq = torch.stack(d_list)                         # [R, C]

    # -- verify phase: the embedding and input product over all positions,
    # the slim recurrence, then one stacked projection
    tok_in = torch.cat([prev[None], d_seq[:R - 1]])     # [R, C]
    xw = w_emb[tok_in.long()] @ w_dec[:E]               # [R, C, 4H]
    h_list, c_list = [], []
    hv, cv = h, c
    for t in range(R):
        g = xw[t] + attend(hv @ w_q) @ w_dec[E:] + hv @ u_dec + b_dec
        gi, gf, gc, go = torch.chunk(g, 4, dim=-1)
        cv = torch.sigmoid(gf) * cv + torch.sigmoid(gi) * torch.tanh(gc)
        hv = torch.sigmoid(go) * torch.tanh(cv)
        h_list.append(hv)
        c_list.append(cv)
    h_seq, c_seq = torch.stack(h_list), torch.stack(c_list)   # [R, C, H]
    logp = torch.log_softmax((h_seq @ w_out + b_out).to(torch.float32),
                             dim=-1)
    g_seq = torch.argmax(logp, dim=-1)                  # [R, C]
    lp_seq = torch.gather(logp, -1, g_seq[..., None])[..., 0]
    g_seq = g_seq.to(torch.int32)

    # -- accept and rollback: position t is emitted iff every earlier
    # proposal matched the target's choice and the slot is live there
    match = g_seq[:R - 1] == d_seq[:R - 1]              # [R-1, C]
    v = active & ~fin & (step < limit)
    valid = [v]
    for t in range(1, R):
        v = (v & match[t - 1] & (g_seq[t - 1] != end_id)
             & (step + t < limit))
        valid.append(v)
    valid = torch.stack(valid)                          # [R, C]
    # int32 sums, as the JAX rule's: torch would widen them to int64, and
    # Step is state the captured graph updates in place
    n_emit = valid.sum(dim=0, dtype=torch.int32)
    accepted = (valid[:R - 1] & match).sum(dim=0, dtype=torch.int32)

    # each emitted token at its own (page, offset); beam 1: parent 0
    ids_pool, par_pool = hist_ids, hist_par
    zero_par = torch.zeros((C, 1), dtype=torch.int32, device=prev.device)
    for t in range(R):
        ids_pool = _paged_hist_write(ids_pool, pt_hist, step + t, page_size,
                                     valid[t], g_seq[t][:, None])
        par_pool = _paged_hist_write(par_pool, pt_hist, step + t, page_size,
                                     valid[t], zero_par)
    # the scores in emission order (the greedy path's left fold)
    acc2 = acc
    for t in range(R):
        acc2 = acc2 + torch.where(valid[t], lp_seq[t], 0.0)

    # roll back to the state after the last emitted token's input
    idx = (n_emit - 1).clamp(min=0).long()
    rows = torch.arange(C, device=prev.device)
    emitted = active & (n_emit > 0)

    def pick(seq, old):
        return torch.where(emitted.reshape((-1,) + (1,) * (old.dim() - 1)),
                           seq[idx, rows], old)

    out = {}
    if hd_seq is not None:
        out['DraftHOut'] = pick(hd_seq, data_of(ins['DraftH'][0]))
        out['DraftCOut'] = pick(cd_seq, data_of(ins['DraftC'][0]))
    h2, c2 = pick(h_seq, h), pick(c_seq, c)
    prev2 = torch.where(emitted, g_seq[idx, rows], prev)
    acc2 = torch.where(emitted, acc2, acc)
    fin2 = fin | (valid & (g_seq == end_id)).any(dim=0)
    step2 = step + n_emit
    bad = active & torch.isnan(acc2)
    active2 = active & ~(active & (fin2 | (step2 >= limit) | bad))
    out.update({
        'HOut': h2[:, None], 'COut': c2[:, None],
        'PrevIdsOut': prev2[:, None], 'AccOut': acc2[:, None],
        'FinOut': fin2[:, None], 'HistIdsOut': ids_pool,
        'HistParOut': par_pool, 'StepOut': step2, 'ActiveOut': active2,
        'Done': active & ~active2, 'Bad': bad,
        'Accepted': torch.where(active, accepted, 0)})
    return out


def _softplus(x):
    """jax.nn.softplus as the softplus rule takes it (math_ops):
    logaddexp(x, 0), no threshold."""
    return torch.logaddexp(x, torch.zeros_like(x))


def nce_negatives(num_total_classes, num_neg_samples, device, generator):
    """The k negatives all rows share, uniform over [0, N), drawn on the
    device (int64 [k])."""
    return torch.randint(0, num_total_classes, (num_neg_samples,),
                         generator=generator, device=device)


def nce_cost(x, label, w, b, neg, num_total_classes, sample_weight=None):
    """NCE's cost for the drawn negatives `neg` (the JAX :23-60): the
    logistic loss of each row's true classes against the k shared
    negatives, every logit corrected by log(k / N). x [B, D], label [B, T]
    or [B], w [N, D], b [N, 1] or None. Returns (Cost [B, 1],
    SampleLogits [B, T + k], SampleLabels int64 [B, T + k])."""
    label = label.long()
    if label.ndim == 1:
        label = label[:, None]
    k = neg.shape[0]
    log_kq = torch.log(torch.tensor(k / num_total_classes, dtype=x.dtype))
    bias = None if b is None else b[:, 0]
    true_logit = torch.einsum('bd,btd->bt', x, take_rows(w, label))
    neg_logit = x @ w.index_select(0, neg).t()              # [B, k]
    if bias is not None:
        true_logit = true_logit + take_rows(bias, label)
        neg_logit = neg_logit + bias.index_select(0, neg)[None, :]
    true_logit = true_logit - log_kq
    neg_logit = neg_logit - log_kq
    cost = (_softplus(-true_logit).sum(dim=1)
            + _softplus(neg_logit).sum(dim=1))[:, None]
    if sample_weight is not None:
        cost = cost * sample_weight.reshape(-1, 1)
    labels = torch.cat([label, neg[None, :].expand(label.shape[0], k)], 1)
    return cost, torch.cat([true_logit, neg_logit], 1), labels


@register('nce')
def _nce(ins, attrs, ctx):
    """Noise-contrastive estimation with a uniform noise law (reference
    nce_op.h's defaults): nce_cost over negatives drawn by nce_negatives
    from ctx.generator."""
    x = data_of(ins['Input'][0])
    n = int(attrs['num_total_classes'])
    neg = nce_negatives(n, int(attrs.get('num_neg_samples', 10)), x.device,
                        ctx.generator)
    cost, logits, labels = nce_cost(
        x, data_of(ins['Label'][0]), data_of(ins['Weight'][0]),
        data_of(ins['Bias'][0]) if ins.get('Bias') else None, neg, n,
        data_of(ins['SampleWeight'][0]) if ins.get('SampleWeight')
        else None)
    return {'Cost': cost, 'SampleLogits': logits, 'SampleLabels': labels}


@register('hierarchical_sigmoid')
def _hierarchical_sigmoid(ins, attrs, ctx):
    """Hierarchical sigmoid over the complete binary tree (reference
    hierarchical_sigmoid_op.h SimpleCode; the JAX :63-97): class c is the
    heap leaf c + C; its path has floor(log2(fp32(c + C))) internal nodes,
    the heap ancestors, each a row of W [C - 1, D] and a branch bit. The
    pre-activations are clipped to [-40, 40] (the port's clip, whose
    gradient at the bound is jnp.clip's) and each node adds the logistic
    loss of its bit; nodes past the path are masked."""
    x = data_of(ins['X'][0])                                # [B, D]
    w = data_of(ins['W'][0])                                # [C - 1, D]
    label = data_of(ins['Label'][0]).long()
    if label.ndim > 1:
        label = label.reshape(label.shape[0])
    bias = data_of(ins['Bias'][0]) if ins.get('Bias') else None
    c = int(attrs['num_classes'])
    max_len = max(1, int(math.ceil(math.log2(c))))
    code = label + c                                        # heap leaf
    length = torch.floor(torch.log2(code.to(torch.float32))).long()
    j = torch.arange(max_len, device=x.device)[None, :]     # [1, L]
    valid = j < length[:, None]
    shift = torch.clamp(length[:, None] - j, min=1)
    anc = torch.bitwise_right_shift(code[:, None], shift)   # ancestors
    bit = torch.bitwise_right_shift(code[:, None], shift - 1) & 1
    idx = torch.clamp(anc - 1, 0, c - 2)                    # W's row
    pre = torch.einsum('bd,bld->bl', x, w[idx])
    if bias is not None:
        pre = pre + bias.reshape(-1)[idx]
    pre = _clip(pre, -40.0, 40.0)
    loss = _softplus(pre) - bit.to(pre.dtype) * pre
    out = torch.where(valid, loss, torch.zeros_like(loss)).sum(
        dim=1, keepdim=True)
    return {'Out': out, 'PreOut': pre}


@register('beam_search', best_effort_shapes=True)
def _beam_search(ins, attrs, ctx):
    """One beam step (the JAX :100-153). On dense [batch*beam, K]
    candidates: a joint top-k over beam*K a source, with explicit parent
    pointers instead of the reference's LoD lineage; a finished beam
    (pre_id == end_id) offers one end_id candidate carrying its score.
    Ties keep the lower index, as lax.top_k does.

    When pre_scores is a 2-level SeqValue (the book's While-loop LoD
    decoder) the step follows the reference beam_search_op.cc algorithm
    on the capacity form instead (lod_beam.py)."""
    from .lod_beam import (beam_search_step, normalize_capacity,
                           top_k_lower_index)
    psc = ins['pre_scores'][0] if ins.get('pre_scores') else None
    beam = int(attrs['beam_size'])
    end_id = int(attrs['end_id'])
    if isinstance(psc, SeqValue) and psc.outer_lengths:
        p_ids, p_sc, cids, csc = normalize_capacity(
            ins['pre_ids'][0], psc, ins['ids'][0], ins['scores'][0], beam)
        sel_ids, sel_scores, parents = beam_search_step(
            p_ids, p_sc, cids, csc, beam, end_id)
        return {'selected_ids': sel_ids, 'selected_scores': sel_scores,
                'parent_idx': parents.long()}
    pre_ids = data_of(ins['pre_ids'][0]).long()              # [B*b, 1]
    ids = data_of(ins['ids'][0]).long()                      # [B*b, K]
    scores = data_of(ins['scores'][0]).to(torch.float32)     # [B*b, K]
    Bb, K = ids.shape
    B = Bb // beam
    if psc is None:
        raise ValueError(
            "beam_search requires pre_scores (the previous step's "
            "selected_scores) to carry finished beams' scores forward")
    finished = pre_ids[:, 0] == end_id                       # [B*b]
    keep_score = data_of(psc).to(torch.float32).reshape(Bb)
    first = torch.arange(K, device=ids.device)[None, :] == 0
    cand_scores = torch.where(
        finished[:, None],
        torch.where(first, keep_score[:, None], float('-inf')), scores)
    cand_ids = torch.where(finished[:, None], end_id, ids)
    top_scores, top_pos = top_k_lower_index(
        cand_scores.reshape(B, beam * K), beam)              # [B, beam]
    # the global row of each parent in [B*beam]: directly gatherable for
    # the dense beam-state reorder (contrib BeamSearchDecoder)
    parent = torch.div(top_pos, K, rounding_mode='floor') + \
        torch.arange(B, device=ids.device)[:, None] * beam
    sel_ids = torch.gather(cand_ids.reshape(B, beam * K), 1, top_pos)
    return {'selected_ids': sel_ids.reshape(Bb, 1),
            'selected_scores': top_scores.reshape(Bb, 1),
            'parent_idx': parent.reshape(Bb)}


@register('beam_search_decode', best_effort_shapes=True)
def _beam_search_decode(ins, attrs, ctx):
    """Backtrace per-step beams into sentences (the JAX :692-744).

    Dense contract: Ids and Scores are [T, batch, beam]; Parents [T,
    batch, beam] gives each step's source beam (beam_search's global
    rows, taken modulo beam). SentenceIds [batch, beam, T], padded past a
    sentence's first end_id with end_id when the op has an end_id attr;
    SentenceScores [batch, beam], the last step's scores.

    Passed the LoDTensorArrays themselves (the book's While-loop decoder),
    it backtraces them with the reference algorithm instead
    (lod_beam.beam_search_decode_arrays) into 2-level LoD sentences."""
    from ..lowering import ArrayValue
    if isinstance(ins['Ids'][0], ArrayValue):
        if not ins['Ids'][0].is_seq:
            raise TypeError(
                'beam_search_decode on a LoDTensorArray requires LoD '
                '(beam_search-written) elements; for dense per-step beams '
                'pass stacked [T, batch, beam] tensors + parents instead '
                '(layers.beam_search_decode dense contract)')
        from .lod_beam import beam_search_decode_arrays
        sent_ids, sent_scores = beam_search_decode_arrays(
            ins['Ids'][0], ins['Scores'][0],
            int(attrs.get('beam_size', 0) or 0),
            int(attrs.get('end_id', 0)))
        return {'SentenceIds': sent_ids, 'SentenceScores': sent_scores}
    ids = data_of(ins['Ids'][0]).long()                     # [T, B, beam]
    scores = data_of(ins['Scores'][0]).to(torch.float32)
    T, B, beam = ids.shape
    if ins.get('Parents'):
        parents = torch.remainder(data_of(ins['Parents'][0]).long(), beam)
    else:
        parents = torch.arange(beam, device=ids.device)[None, None, :] \
            .expand(T, B, beam)
    ptr = torch.arange(beam, device=ids.device)[None, :].expand(B, beam)
    toks = []
    for t in range(T - 1, -1, -1):
        toks.append(torch.gather(ids[t], 1, ptr))
        ptr = torch.gather(parents[t], 1, ptr)
    sent = torch.stack(toks[::-1], dim=-1)                  # [B, beam, T]
    if 'end_id' in attrs:
        end_id = int(attrs['end_id'])
        ended = torch.cumsum((sent == end_id).long(), dim=-1) > 0
        prev_ended = torch.cat([torch.zeros_like(ended[..., :1]),
                                ended[..., :-1]], dim=-1)
        sent = torch.where(prev_ended, end_id, sent)
    return {'SentenceIds': sent,
            'SentenceScores': scores[-1].reshape(B, beam)}
