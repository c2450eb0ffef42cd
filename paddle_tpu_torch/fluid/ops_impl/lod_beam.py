"""Step-form beam decode: one attention-LSTM beam step and the host-side
backtrace.

Parity: the JAX package's fluid/ops_impl/lod_beam.py, only its step-form
decode (beam_init_carry :308, attention_beam_step :322, greedy_attend_cell
:386, backtrace_beams :420), which the continuous-batching DecodeEngine
drives slot by slot through the decode-step rules of sampled_ops.py, and
which attention_lstm_beam_decode loops over the whole decode. Every row is
independent: no cross-row reduction mixes two sources, which is what lets
the engine pack unrelated slots into one step and mask the dead ones.

The joint top-k keeps lax.top_k's rule on ties, the lower index first: a
stable descending sort of the values' total-order keys (torch.topk
promises no order among equal values on the card). Ties at finfo(f32).min are common: a finished beam offers
one live candidate, so a slot whose beams all finished has beam * V - beam
candidates tied there.
"""
import numpy as np
import torch

from ...ops.kernels.paged_attention import attend as attend_rows

__all__ = ['beam_init_carry', 'attention_beam_step', 'greedy_attend_cell',
           'backtrace_beams', 'top_k_lower_index']

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
