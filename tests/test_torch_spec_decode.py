"""Speculative decoding in the port (fluid/ops_impl/sampled_ops.py
attention_lstm_spec_decode_step; serving/decode.py DecodeConfig(spec_k=)
and DecodeEngine(draft=)) against the JAX package's, on the CPU, at the
small shapes of tests/test_decode.py:41-43 (V, E, D, H = 20, 8, 6, 8;
src_cap 5; max_len 8; page_size 3):

  * the engine at spec_k 3 and 8 with the target as its own draft, and
    with an adversarial next-token table (tests/test_decode.py:560, :595):
    tokens exact against the port's beam-1 paged engine (the greedy
    decode) and against the JAX speculative engine, scores within
    TOL = 1e-5; the accept rate in (0, 1], below 0.5 for the wrong draft;
    no cache miss after warmup();
  * one dispatch of the rule against the JAX rule from the same state, for
    a self draft, a smaller weights draft and a table draft: every output,
    Accepted included, ints equal and floats within TOL;
  * DecodeConfig's and DecodeEngine's spec validation, the same errors as
    the JAX classes.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu.fluid  # noqa: F401  (registers the JAX rules)
from paddle_tpu.fluid import lowering as jlow
from paddle_tpu.serving import DecodeConfig as JDecodeConfig
from paddle_tpu.serving import DecodeEngine as JDecodeEngine

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import serving
from paddle_tpu_torch.fluid import lowering as tlow

from test_torch_generation import WEIGHTS, _weights, _encs

V, E, D, H = 20, 8, 6, 8
SRC = 5
MAXLEN = 8
PS = 3
TOL = 1e-5
CPU = tfluid.CPUPlace()


def _greedy(encs, lims):
    """The greedy target-only decode: the port's beam-1 paged engine."""
    eng = serving.DecodeEngine(WEIGHTS, serving.DecodeConfig(
        slots=4, beam_size=1, max_len=MAXLEN, src_cap=SRC, page_size=PS,
        pages=12), place=CPU)
    try:
        eng.warmup()
        futs = [eng.submit({'enc': e}, max_new_tokens=n)
                for e, n in zip(encs, lims)]
        return [f.result(60) for f in futs]
    finally:
        eng.shutdown()


def _spec(encs, lims, spec_k, draft, jax_engine=False):
    """The speculative engine's results and stats (port or JAX)."""
    cfg = dict(slots=2, beam_size=1, max_len=MAXLEN, src_cap=SRC,
               page_size=PS, pages=12, spec_k=spec_k)
    if jax_engine:
        eng = JDecodeEngine(WEIGHTS, JDecodeConfig(**cfg), draft=draft)
    else:
        eng = serving.DecodeEngine(WEIGHTS, serving.DecodeConfig(**cfg),
                                   place=CPU, draft=draft)
    try:
        eng.warmup()
        misses0 = eng.cache_stats()['misses']
        futs = [eng.submit({'enc': e}, max_new_tokens=n)
                for e, n in zip(encs, lims)]
        res = [f.result(60) for f in futs]
        assert eng.cache_stats()['misses'] == misses0
        return res, eng.stats, eng.stats_window()
    finally:
        eng.shutdown()


def _assert_same(got, want, what):
    for i, ((tg, sg), (tw, sw)) in enumerate(zip(got, want)):
        assert tg.dtype == np.int64
        assert np.array_equal(tg, np.asarray(tw)), (what, i)
        np.testing.assert_allclose(sg, np.asarray(sw), rtol=TOL, atol=TOL,
                                   err_msg='%s %d' % (what, i))


@pytest.mark.parametrize('spec_k', [3, 8])
def test_self_draft_is_token_exact(spec_k):
    """Limits that do not divide spec_k and bonus emissions past it: with
    the target as draft every proposal is accepted, so a dispatch emits
    more than one token."""
    rng = np.random.RandomState(21)
    encs = _encs(rng, 6)
    lims = [3, MAXLEN, 5, 1, 7, MAXLEN]
    res, st, win = _spec(encs, lims, spec_k, WEIGHTS)
    _assert_same(res, _greedy(encs, lims), 'greedy engine')
    jres, jst, _ = _spec(encs, lims, spec_k, WEIGHTS, jax_engine=True)
    _assert_same(res, jres, 'JAX speculative engine')
    assert st['spec_proposed'] > 0
    assert 0.0 < st['spec_accept_rate'] <= 1.0
    assert st['spec_accept_rate'] == jst['spec_accept_rate']
    assert win['spec_accept_rate'] == st['spec_accept_rate']
    assert st['steps'] < st['tokens']


def test_wrong_table_draft_rolls_back_token_exact():
    """An adversarial next-token table: the mismatch and rollback path on
    nearly every dispatch."""
    rng = np.random.RandomState(22)
    encs = _encs(rng, 5)
    lims = [MAXLEN, 4, MAXLEN, 2, 6]
    table = rng.randint(0, V, V).astype(np.int32)
    res, st, _ = _spec(encs, lims, 4, table)
    _assert_same(res, _greedy(encs, lims), 'greedy engine')
    jres, jst, _ = _spec(encs, lims, 4, table, jax_engine=True)
    _assert_same(res, jres, 'JAX speculative engine')
    assert st['spec_accept_rate'] < 0.5
    assert st['spec_accepted'] == jst['spec_accepted']


def test_small_weights_draft_is_token_exact():
    """A draft of its own width (E = H = 4): its state rides in DraftH /
    DraftC and is zeroed at each join."""
    rng = np.random.RandomState(23)
    encs = _encs(rng, 5)
    lims = [MAXLEN, 6, 3, MAXLEN, 5]
    draft = _weights(np.random.RandomState(8), e=4, h=4)
    res, st, _ = _spec(encs, lims, 3, draft)
    _assert_same(res, _greedy(encs, lims), 'greedy engine')
    jres, jst, _ = _spec(encs, lims, 3, draft, jax_engine=True)
    _assert_same(res, jres, 'JAX speculative engine')
    assert st['spec_accepted'] == jst['spec_accepted']


# -- one dispatch of the rule ---------------------------------------------------

C, SPEC_K = 4, 3
NPE = -(-SRC // PS)
NPH = -(-MAXLEN // PS)
PAGES = C * NPH


def _rule_inputs(draft):
    """A mid-flight slot pool at beam 1: slot 0 near its limit, slot 1
    inactive, slot 2 finished, slot 3 fresh; each slot its own history
    pages, encoder pages (page 0 the zero page) and a masked tail."""
    rng = np.random.RandomState(31)
    enc_pages = (rng.randn(1 + C * NPE, PS, D) * 0.5).astype(np.float32)
    enc_pages[0] = 0
    mask_pages = np.ones((1 + C * NPE, PS), np.float32)
    mask_pages[0] = 0
    mask_pages[2, 1:] = 0                    # slot 0 has 4 live rows
    pt_enc = (1 + np.arange(C * NPE, dtype=np.int32)).reshape(C, NPE)
    pt_hist = np.arange(PAGES, dtype=np.int32).reshape(C, NPH)
    pt_hist[1] = PAGES                        # unassigned: writes drop
    ins = {k: WEIGHTS[w] for k, w in (
        ('WDec', 'w_dec'), ('UDec', 'u_dec'), ('BDec', 'b_dec'),
        ('WAttnQ', 'w_q'), ('WEmb', 'w_emb'), ('WOut', 'w_out'),
        ('BOut', 'b_out'))}
    ins.update({
        'H': (rng.randn(C, 1, H) * 0.5).astype(np.float32),
        'C': (rng.randn(C, 1, H) * 0.5).astype(np.float32),
        'PrevIds': rng.randint(0, V, (C, 1)).astype(np.int32),
        'Acc': (-rng.rand(C, 1) * 3).astype(np.float32),
        'Fin': np.array([[0], [0], [1], [0]], bool),
        'Step': np.array([6, 0, 3, 0], np.int32),
        'Limit': np.array([MAXLEN, MAXLEN, 5, MAXLEN], np.int32),
        'Active': np.array([1, 0, 1, 1], bool),
        'PtHist': pt_hist, 'PtEnc': pt_enc,
        'HistIds': rng.randint(0, V, (PAGES, PS, 1)).astype(np.int32),
        'HistPar': np.zeros((PAGES, PS, 1), np.int32),
        'EncPages': enc_pages, 'MaskPages': mask_pages})
    if draft == 'table':
        ins['DraftTable'] = rng.randint(0, V, V).astype(np.int32)
    else:
        dw = WEIGHTS if draft == 'self' else _weights(
            np.random.RandomState(8), e=4, h=4)
        for k, w in (('WDec', 'w_dec'), ('UDec', 'u_dec'),
                     ('BDec', 'b_dec'), ('WAttnQ', 'w_q'),
                     ('WEmb', 'w_emb'), ('WOut', 'w_out'),
                     ('BOut', 'b_out')):
            ins['Draft' + k] = dw[w]
        hd = dw['u_dec'].shape[0]
        ins['DraftH'] = (rng.randn(C, hd) * 0.5).astype(np.float32)
        ins['DraftC'] = (rng.randn(C, hd) * 0.5).astype(np.float32)
        if draft == 'self':
            # in step with the target, as a self draft is in the engine
            ins['DraftH'] = ins['H'][:, 0].copy()
            ins['DraftC'] = ins['C'][:, 0].copy()
    attrs = {'end_id': 1, 'spec_k': SPEC_K, 'page_size': PS,
             'src_cap': SRC, 'draft': 'table' if draft == 'table'
             else 'weights'}
    return ins, attrs


@pytest.mark.parametrize('draft', ['self', 'weights', 'table'])
def test_spec_rule_matches_the_jax_rule(draft):
    ins, attrs = _rule_inputs(draft)
    j = jlow.get_rule('attention_lstm_spec_decode_step')(
        {k: [jnp.asarray(v)] for k, v in ins.items()}, attrs,
        jlow.Ctx(jax.random.key(0), platform='cpu'))
    t = tlow.get_rule('attention_lstm_spec_decode_step')(
        {k: [torch.from_numpy(np.array(v))] for k, v in ins.items()}, attrs,
        tlow.Ctx(torch.device('cpu'), torch.Generator()))
    assert sorted(t) == sorted(j)
    assert 'Accepted' in t and ('DraftHOut' in t) == (draft != 'table')
    for k in sorted(j):
        a, b = t[k].numpy(), np.asarray(j[k])
        assert a.shape == b.shape and a.dtype == b.dtype, (k, a.dtype,
                                                           b.dtype)
        if b.dtype.kind in 'iub':
            assert np.array_equal(a, b), (k, a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL, err_msg=k)
    # the inactive slot keeps its state and accepts nothing
    assert t['Accepted'][1] == 0 and not t['ActiveOut'][1]
    assert torch.equal(t['HOut'][1], torch.from_numpy(ins['H'][1]))
    if draft == 'self':
        assert int(t['Accepted'][3]) == SPEC_K or bool(t['FinOut'][3, 0])


# -- validation -------------------------------------------------------------------

def test_spec_config_and_draft_validation():
    for kw, match in (
            (dict(spec_k=4), 'page_size'),
            (dict(beam_size=2, page_size=4, pages=8, spec_k=2),
             'beam_size=1'),
            (dict(beam_size=1, page_size=4, pages=8, spec_k=2, bundle=4),
             'mutually exclusive'),
            (dict(beam_size=1, page_size=4, pages=8, spec_k=-1),
             'spec_k must be')):
        with pytest.raises(ValueError, match=match):
            serving.DecodeConfig(**kw)
        with pytest.raises(ValueError, match=match):
            JDecodeConfig(**kw)
    cfg = dict(beam_size=1, page_size=4, pages=8, spec_k=2)
    small = _weights(np.random.RandomState(8), e=4, h=4)
    for draft, cfg_kw, match in (
            (None, cfg, 'needs a draft'),
            (np.zeros(3, np.int32), cfg, 'vocab'),
            (np.zeros(V, np.float32), cfg, 'int next-token'),
            ({'w_dec': small['w_dec']}, cfg, 'missing'),
            (dict(small, w_out=np.zeros((4, V + 1), np.float32)), cfg,
             'share the target vocab'),
            (WEIGHTS, dict(beam_size=1), 'needs DecodeConfig')):
        with pytest.raises(ValueError, match=match):
            serving.DecodeEngine(WEIGHTS, serving.DecodeConfig(**cfg_kw),
                                 place=CPU, draft=draft)
        with pytest.raises(ValueError, match=match):
            JDecodeEngine(WEIGHTS, JDecodeConfig(**cfg_kw), draft=draft)
