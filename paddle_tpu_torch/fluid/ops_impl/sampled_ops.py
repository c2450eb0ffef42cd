"""Decode-step rules of the continuous-batching DecodeEngine.

Parity: the JAX package's fluid/ops_impl/sampled_ops.py, only the two
step-form beam rules the engine drives, `attention_lstm_beam_decode_step`
(dense slot buffers, :221) and `attention_lstm_beam_paged_step` (page
pools, :393), with their helpers `_masked_beam_advance` :326,
`_decode_weight_params` :347 and `_paged_hist_write` :379. Both rules
share `_masked_beam_advance`, so the paged engine matches the dense one by
construction. `_gather_paged_enc` :361 serves only the JAX rule's
kernel-off branch; here its gather is paged_attention's plain version.

The paged rule calls `ops.kernels.paged_attention` unconditionally: on the
card that launches the CUDA kernel, on the CPU its plain version. There is
no switch (the JAX package's PADDLE_TPU_KERNELS knob has no counterpart).

`bundle > 1` runs that many steps as a Python loop in one dispatch, with
no host sync inside it (the JAX rule's lax.scan); slots that finish
mid-bundle freeze, so results equal bundle=1. Nothing here reads a value
back to the host.

Torch has no `mode='drop'` scatter. The history write redirects invalid
rows to a scratch row appended past the pool and drops it: two live slots
never share a history page, so every kept row has exactly one writer and
the result does not depend on the order `index_put_` applies duplicate
indices in (only the dropped rows collide, on the scratch row).
"""
import torch

from ...ops.kernels import paged_attention
from ..lowering import register, data_of
from .lod_beam import attention_beam_step


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


def _decode_weight_params(ins):
    """The WEIGHT_KEYS tuple (w_dec, u_dec, b_dec, w_q, w_emb, w_out,
    b_out) from op inputs; a missing bias is 0."""
    return (data_of(ins['WDec'][0]), data_of(ins['UDec'][0]),
            data_of(ins['BDec'][0]) if ins.get('BDec') else 0.0,
            data_of(ins['WAttnQ'][0]), data_of(ins['WEmb'][0]),
            data_of(ins['WOut'][0]),
            data_of(ins['BOut'][0]) if ins.get('BOut') else 0.0)


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
