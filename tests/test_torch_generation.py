"""Machine translation generation and token-fed decode in the port
(fluid/ops_impl/sampled_ops.py attention_lstm_beam_decode,
lod_beam.greedy_attend_cell, models/machine_translation.py with
is_generating=True, serving/decode.py LockstepDecoder, program_prefill and
DecodeEngine(prefill=)) against the JAX package's, on the CPU, at the
small shapes of tests/test_decode.py:41-43 (V, E, D, H, K = 20, 8, 6, 8,
3; src_cap 5; max_len 8; page_size 3):

  * the whole-sequence beam decode rule and the greedy cell, called
    directly in both packages on the same numpy inputs with a masked
    (zero-length) encoder row: tokens equal, scores and values within
    TOL = 1e-5; the rule's build-time inference on meta tensors;
  * seq_to_seq_net(is_generating=True) (emb, encoder and decoder 16,
    vocab 12, beam 2, max_length 4) built in both packages op for op, the
    JAX startup weights carried over by name: SentenceIds equal, scores
    within 1e-5;
  * the JAX echo drill (tests/test_ops_sampled.py:144-194) in the port:
    150 Adam steps, then the best beam emits [src_tok, end];
  * the port's LockstepDecoder against the JAX one;
  * program_prefill A/B (tests/test_decode.py:221) for the dense and the
    paged engine: bit-exact against the port's lockstep over the
    prefill's own encoder rows, tokens equal and scores within 1e-5
    against the JAX lockstep;
  * the prefill drills (tests/test_decode.py:390, :714, :747): a prefix
    hit joins without a prefill; a prefill fault, and a malformed prefill
    return, fail only the joining futures;
  * without a card, LockstepDecoder() and DecodeEngine(prefill=) with no
    place raise (they default to the card).
"""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import framework as jframework
from paddle_tpu.fluid import lowering as jlow
from paddle_tpu.fluid import unique_name as junique
from paddle_tpu.fluid.executor import Scope as JScope
from paddle_tpu.fluid.ops_impl import lod_beam as jbeam
from paddle_tpu.models import machine_translation as jmt
from paddle_tpu.serving import LockstepDecoder as JLockstepDecoder

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import obs, serving
from paddle_tpu_torch.fluid import framework as tframework
from paddle_tpu_torch.fluid import lowering as tlow
from paddle_tpu_torch.fluid import unique_name as tunique
from paddle_tpu_torch.fluid.ops_impl import lod_beam as tbeam
from paddle_tpu_torch.models import machine_translation as tmt
from paddle_tpu_torch.serving.decode import WEIGHT_KEYS

from test_torch_training import _assert_same_program

V, E, D, H, K = 20, 8, 6, 8, 3
SRC = 5          # src_cap
MAXLEN = 8
TOL = 1e-5
CPU = tfluid.CPUPlace()


def _weights(rng, e=E, h=H):
    return {
        'w_dec': (rng.randn(e + D, 4 * h) * 0.3).astype(np.float32),
        'u_dec': (rng.randn(h, 4 * h) * 0.3).astype(np.float32),
        'b_dec': (rng.randn(1, 4 * h) * 0.1).astype(np.float32),
        'w_q': (rng.randn(h, D) * 0.3).astype(np.float32),
        'w_emb': (rng.randn(V, e) * 0.3).astype(np.float32),
        'w_out': (rng.randn(h, V) * 0.3).astype(np.float32),
        'b_out': (rng.randn(1, V) * 0.1).astype(np.float32),
    }


WEIGHTS = _weights(np.random.RandomState(7))


def _ctx_jax():
    return jlow.Ctx(jax.random.key(0), is_test=False, platform='cpu')


def _ctx_port():
    return tlow.Ctx(torch.device('cpu'), torch.Generator())


def _encs(rng, n, lo=2):
    return [(rng.randn(rng.randint(lo, SRC + 1), D) * 0.5)
            .astype(np.float32) for _ in range(n)]


def _padded(encs):
    lens = np.asarray([e.shape[0] for e in encs], np.int32)
    enc = np.zeros((len(encs), SRC, D), np.float32)
    for i, e in enumerate(encs):
        enc[i, :e.shape[0]] = e
    return enc, lens


def _assert_decodes(got, want, what, exact=False):
    """Tokens equal; scores bitwise (exact) or within TOL."""
    (tg, sg), (tw, sw) = got, want
    assert np.array_equal(np.asarray(tg), np.asarray(tw)), what
    if exact:
        assert np.array_equal(np.asarray(sg), np.asarray(sw)), what
    else:
        np.testing.assert_allclose(np.asarray(sg), np.asarray(sw), rtol=TOL,
                                   atol=TOL, err_msg=str(what))


# -- the rules ----------------------------------------------------------------

def _decode_ins(enc, lens):
    return {'EncOut': (enc, lens), 'WDec': WEIGHTS['w_dec'],
            'UDec': WEIGHTS['u_dec'], 'BDec': WEIGHTS['b_dec'],
            'WAttnQ': WEIGHTS['w_q'], 'WEmb': WEIGHTS['w_emb'],
            'WOut': WEIGHTS['w_out'], 'BOut': WEIGHTS['b_out']}


def _run_rule(op_type, ins, attrs):
    """The op's rule in both packages; a (data, lengths) input is a
    sequence. Returns (jax outputs, port outputs)."""
    jins, tins = {}, {}
    for slot, v in ins.items():
        if isinstance(v, tuple):
            jins[slot] = [jlow.SeqValue(jnp.asarray(v[0]),
                                        jnp.asarray(v[1], jnp.int32))]
            tins[slot] = [tlow.SeqValue(torch.from_numpy(v[0].copy()),
                                        torch.from_numpy(
                                            v[1].astype(np.int64)))]
        else:
            jins[slot] = [jnp.asarray(v)]
            tins[slot] = [torch.from_numpy(np.array(v))]
    return (jlow.get_rule(op_type)(jins, attrs, _ctx_jax()),
            tlow.get_rule(op_type)(tins, attrs, _ctx_port()))


@pytest.mark.parametrize('max_len', [1, MAXLEN])
def test_beam_decode_rule_matches_the_jax_rule(max_len):
    """Four sources, the second with no valid encoder row (its attention
    is uniform over the padded axis in both packages)."""
    rng = np.random.RandomState(3)
    lens = np.array([3, 0, SRC, 1])
    enc = (rng.randn(4, SRC, D) * 0.5).astype(np.float32)
    for i, n in enumerate(lens):
        enc[i, n:] = 0
    attrs = {'beam_size': K, 'max_len': max_len, 'start_id': 0,
             'end_id': 1}
    j, t = _run_rule('attention_lstm_beam_decode', _decode_ins(enc, lens),
                     attrs)
    ids, scores = t['SentenceIds'], t['SentenceScores']
    assert ids.dtype == torch.int64 and tuple(ids.shape) == (4, K, max_len)
    assert scores.dtype == torch.float32 and tuple(scores.shape) == (4, K)
    _assert_decodes((ids.numpy(), scores.numpy()),
                    (j['SentenceIds'], j['SentenceScores']), max_len)


def test_beam_decode_rule_infers_its_shapes_on_meta_tensors():
    """Build-time inference runs one step, not max_len."""
    meta = lambda *s: torch.empty(s, device='meta')
    ins = {'EncOut': [tlow.SeqValue(meta(7, 11, D),
                                    torch.empty(7, dtype=torch.int64,
                                                device='meta'))]}
    for slot, k in (('WDec', 'w_dec'), ('UDec', 'u_dec'),
                    ('BDec', 'b_dec'), ('WAttnQ', 'w_q'), ('WEmb', 'w_emb'),
                    ('WOut', 'w_out'), ('BOut', 'b_out')):
        ins[slot] = [meta(*WEIGHTS[k].shape)]
    out = tlow.get_rule('attention_lstm_beam_decode')(
        ins, {'beam_size': K, 'max_len': 50, 'end_id': 1},
        tlow.Ctx(torch.device('meta')))
    assert tuple(out['SentenceIds'].shape) == (7, K, 50)
    assert out['SentenceIds'].dtype == torch.int64
    assert tuple(out['SentenceScores'].shape) == (7, K)
    assert out['SentenceScores'].dtype == torch.float32


@pytest.mark.parametrize('override', [False, True])
def test_greedy_attend_cell_matches_the_jax_cell(override):
    """The draft's step, a masked row included; with `attend` given (the
    paged kernel's seam) the port's cell gives its inline result
    bitwise."""
    rng = np.random.RandomState(9)
    B = 4
    enc = (rng.randn(B, SRC, D) * 0.5).astype(np.float32)
    mask = (np.arange(SRC)[None] < np.array([[2], [0], [5], [3]])).astype(
        np.float32)
    h = (rng.randn(B, H) * 0.5).astype(np.float32)
    c = (rng.randn(B, H) * 0.5).astype(np.float32)
    tok = rng.randint(0, V, B).astype(np.int32)
    jp = tuple(jnp.asarray(WEIGHTS[k]) for k in WEIGHT_KEYS)
    tp = tuple(torch.from_numpy(WEIGHTS[k]) for k in WEIGHT_KEYS)
    jh, jc, jl = jbeam.greedy_attend_cell(jp, jnp.asarray(enc),
                                          jnp.asarray(mask), jnp.asarray(h),
                                          jnp.asarray(c), jnp.asarray(tok))
    te, tm = torch.from_numpy(enc), torch.from_numpy(mask)
    args = (torch.from_numpy(h), torch.from_numpy(c), torch.from_numpy(tok))
    if override:
        got = tbeam.greedy_attend_cell(
            tp, None, None, *args,
            attend=lambda q: tbeam.attend_rows(q, te, tm))
        inline = tbeam.greedy_attend_cell(tp, te, tm, *args)
        for a, b in zip(got, inline):
            assert torch.equal(a, b)
    else:
        got = tbeam.greedy_attend_cell(tp, te, tm, *args)
    assert got[2].dtype == torch.float32 and tuple(got[2].shape) == (B, V)
    for a, b in zip(got, (jh, jc, jl)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                   atol=TOL)


# -- the generating program ---------------------------------------------------

GEN = dict(embedding_dim=16, encoder_size=16, decoder_size=16,
           source_dict_dim=12, target_dict_dim=12, is_generating=True,
           beam_size=2, max_length=4)


def _generating(fluid, framework, unique_name, mt):
    main, startup = framework.Program(), framework.Program()
    with unique_name.guard(), framework.program_guard(main, startup):
        ids, scores = mt.seq_to_seq_net(**GEN)
    return main, startup, ids, scores


def test_generating_program_matches_the_jax_program():
    jmain, jstart, jids, jsc = _generating(jfluid, jframework, junique, jmt)
    tmain, tstart, tids, tsc = _generating(tfluid, tframework, tunique, tmt)
    _assert_same_program(jmain, tmain)
    _assert_same_program(jstart, tstart)
    assert [op.type for op in tmain.global_block().ops][-1] == \
        'attention_lstm_beam_decode'
    assert tids.shape == (-1, 2, 4) and tids.dtype == 'int64'
    assert tsc.shape == (-1, 2) and tsc.dtype == 'float32'
    jscope = JScope()
    with jfluid.scope_guard(jscope):
        jexe = jfluid.Executor(jfluid.CPUPlace())
        jexe.run(jstart)
    init = {n: np.array(v) for n, v in jscope.vars.items()}
    tscope = tfluid.Scope()
    tscope.load_numpy(init, CPU)
    rng = np.random.RandomState(1)
    lt = [[3, 1, 5, 2]]
    rows = rng.randint(2, 12, (sum(lt[0]), 1)).astype(np.int64)
    with jfluid.scope_guard(jscope):
        want = jexe.run(jmain, feed={'source_sequence':
                                     jfluid.LoDTensor(rows, lt)},
                        fetch_list=[jids, jsc])
    got = tfluid.Executor(CPU).run(
        tmain, feed={'source_sequence': tfluid.LoDTensor(rows, lt)},
        fetch_list=[tids, tsc], scope=tscope)
    assert got[0].dtype == np.int64 and got[0].shape == (4, 2, 4)
    _assert_decodes(got, want, 'generating program')


def test_echo_drill_best_beam_emits_the_source_token_then_end():
    """tests/test_ops_sampled.py:144-194 in the port: train the tiny
    seq2seq to echo its one source token, then beam-decode."""
    Vs = 12
    main, startup = tframework.Program(), tframework.Program()
    main.random_seed = startup.random_seed = 1
    with tunique.guard(), tframework.program_guard(main, startup):
        avg_cost, _ = tmt.seq_to_seq_net(16, 16, 16, Vs, Vs)
        tfluid.optimizer.Adam(learning_rate=0.01).minimize(avg_cost)
    infer = tframework.Program()
    with tunique.guard(), tframework.program_guard(infer,
                                                   tframework.Program()):
        sent_ids, sent_scores = tmt.seq_to_seq_net(
            16, 16, 16, Vs, Vs, is_generating=True, beam_size=2,
            max_length=4)
    exe = tfluid.Executor(CPU)
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    B = 8
    losses = []
    for _ in range(150):
        toks = rng.randint(2, Vs, (B,)).astype(np.int64)
        src = tfluid.create_lod_tensor(toks[:, None], [[1] * B], CPU)
        trg = tfluid.create_lod_tensor(
            np.stack([np.zeros(B, np.int64), toks], 1).reshape(-1, 1),
            [[2] * B], CPU)
        lab = tfluid.create_lod_tensor(
            np.stack([toks, np.ones(B, np.int64)], 1).reshape(-1, 1),
            [[2] * B], CPU)
        loss, = exe.run(main, feed={'source_sequence': src,
                                    'target_sequence': trg,
                                    'label_sequence': lab},
                        fetch_list=[avg_cost], scope=scope)
        losses.append(float(np.asarray(loss).reshape(-1)[0]))
    assert losses[-1] < losses[0] * 0.5, (losses[0], losses[-1])
    toks = np.array([3, 7], np.int64)
    src = tfluid.create_lod_tensor(toks[:, None], [[1, 1]], CPU)
    out_ids, out_scores = exe.run(infer, feed={'source_sequence': src},
                                  fetch_list=[sent_ids, sent_scores],
                                  scope=scope)
    assert out_ids.shape == (2, 2, 4) and out_scores.shape == (2, 2)
    assert out_ids[0, 0, 0] == 3 and out_ids[1, 0, 0] == 7
    assert out_ids[0, 0, 1] == 1 and out_ids[1, 0, 1] == 1     # <end>


# -- LockstepDecoder and program_prefill ---------------------------------------

def test_lockstep_decoder_matches_the_jax_one():
    enc, lens = _padded(_encs(np.random.RandomState(2), 6, lo=1))
    got = serving.LockstepDecoder(WEIGHTS, K, MAXLEN, SRC,
                                  place=CPU).run(enc, lens)
    want = JLockstepDecoder(WEIGHTS, beam_size=K, max_len=MAXLEN,
                            src_cap=SRC).run(enc, lens)
    assert got[0].dtype == np.int64 and got[0].shape == (6, K, MAXLEN)
    assert got[1].dtype == np.float32 and got[1].shape == (6, K)
    _assert_decodes(got, want, 'lockstep')
    # encoder rows narrower than src_cap are padded to it
    short = serving.LockstepDecoder(WEIGHTS, K, MAXLEN, SRC,
                                    place=CPU).run(enc[:, :3],
                                                   np.minimum(lens, 3))
    again = serving.LockstepDecoder(WEIGHTS, K, MAXLEN, SRC,
                                    place=CPU).run(
        np.concatenate([enc[:, :3], np.zeros_like(enc[:, 3:])], 1),
        np.minimum(lens, 3))
    _assert_decodes(short, again, 'padded', exact=True)


def _prefill_program():
    main, startup = tframework.Program(), tframework.Program()
    main.random_seed = startup.random_seed = 3
    with tunique.guard(), tframework.program_guard(main, startup):
        src = tfluid.layers.data(name='src', shape=[1], dtype='int64',
                                 lod_level=1)
        emb = tfluid.layers.embedding(input=src, size=[V, E])
        enc = tfluid.layers.fc(input=emb, size=D, num_flatten_dims=2)
    exe = tfluid.Executor(CPU)
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    return serving.program_prefill(exe, main, scope, 'src', enc,
                                   token_cap=SRC)


@pytest.mark.parametrize('paged', [False, True])
def test_program_prefill_ab(paged):
    """Admission through an encoder Program (bucketed prefill batches)
    feeds the slot state the direct path would: bit-exact against the
    port's lockstep over the prefill's own encoder rows."""
    rng = np.random.RandomState(3)
    pre = _prefill_program()
    feeds = [{'src': rng.randint(0, V, (rng.randint(2, SRC + 1),))}
             for _ in range(5)]
    enc_out, lens = pre(feeds)
    assert enc_out.shape == (5, SRC, D) and enc_out.dtype == np.float32
    assert list(lens) == [f['src'].shape[0] for f in feeds]
    for i, n in enumerate(lens):
        assert not enc_out[i, n:].any()
    ids_ref, sc_ref = serving.LockstepDecoder(WEIGHTS, K, MAXLEN, SRC,
                                              place=CPU).run(enc_out, lens)
    jids, jsc = JLockstepDecoder(WEIGHTS, beam_size=K, max_len=MAXLEN,
                                 src_cap=SRC).run(enc_out, lens)
    kw = dict(page_size=3, pages=12) if paged else {}
    eng = serving.DecodeEngine(WEIGHTS, serving.DecodeConfig(
        slots=2, beam_size=K, max_len=MAXLEN, src_cap=SRC, **kw),
        place=CPU, prefill=pre)
    try:
        assert eng.warmup(example_feed=feeds[0]) == [1, 2]
        futs = [eng.submit(f) for f in feeds]
        for i, f in enumerate(futs):
            got = f.result(60)
            _assert_decodes(got, (ids_ref[i], sc_ref[i]), i, exact=True)
            _assert_decodes(got, (jids[i], jsc[i]), i)
    finally:
        eng.shutdown()
    with pytest.raises(ValueError, match='token cap'):
        pre([{'src': np.zeros(SRC + 1, np.int64)}])


@pytest.fixture
def events(tmp_path):
    """The run log's events by name."""
    obs.enable(str(tmp_path / 'obs'))

    def read(name):
        path = obs.run_log_path()
        if path is None or not os.path.exists(path):
            return []
        with open(path) as f:
            recs = [json.loads(line) for line in f if line.strip()]
        return [r for r in recs if r['name'] == name]

    try:
        yield read
    finally:
        obs._reset()


def test_prefix_hit_joins_without_prefill(events):
    """tests/test_decode.py:390: the prefill runs once per distinct
    source, hits point their page tables at the resident pages, results
    stay identical, and the steady state adds no cache miss."""
    calls = []

    def prefill(feeds):
        calls.append(len(feeds))
        lens = np.asarray([f['src'].shape[0] for f in feeds], np.int32)
        enc = np.zeros((len(feeds), SRC, D), np.float32)
        for i, f in enumerate(feeds):
            enc[i, :lens[i]] = np.outer(
                np.arange(1, lens[i] + 1), np.ones(D)) * 0.1 * f['src'][0]
        return enc, lens

    eng = serving.DecodeEngine(WEIGHTS, serving.DecodeConfig(
        slots=2, beam_size=K, max_len=MAXLEN, src_cap=SRC, page_size=3,
        pages=12), place=CPU, prefill=prefill)
    try:
        eng.warmup(example_feed={'src': np.ones(3)})
        calls.clear()
        misses0 = eng.cache_stats()['misses']
        a = {'src': np.ones(3)}
        b = {'src': np.full(4, 2.0)}
        ra = [f.result(60) for f in [eng.submit(dict(a)) for _ in range(3)]]
        rb = eng.submit(dict(b)).result(60)
        ra2 = eng.submit(dict(a)).result(60)
        for t, s in ra[1:] + [ra2]:
            assert np.array_equal(t, ra[0][0])
            assert np.array_equal(s, ra[0][1])
        assert not np.array_equal(rb[0], ra[0][0])
        st = eng.stats
        assert st['prefix_hits'] == 3 and st['prefix_misses'] == 2
        # the prefill ran once per distinct source, never for a hit
        assert len(calls) == 2
        assert eng.cache_stats()['misses'] == misses0
        joins = events('decode.join')
        assert sum(e['fields'].get('prefix_hit') is True
                   for e in joins) == 3
        w = eng.stats_window()
        assert w['prefix_hit_rate'] == 0.6
    finally:
        eng.shutdown()


@pytest.mark.parametrize('paged', [False, True])
def test_prefill_failure_fails_only_joiners(events, paged):
    """tests/test_decode.py:714: a prefill fault fails the joining
    requests' futures; later admissions are untouched and, paged, every
    claimed page is back in the pool."""
    arm = {'fail': 0}

    def prefill(feeds):
        if arm['fail']:
            arm['fail'] -= 1
            raise RuntimeError('injected prefill fault')
        lens = np.asarray([f['enc'].shape[0] for f in feeds], np.int32)
        enc = np.zeros((len(feeds), SRC, D), np.float32)
        for i, f in enumerate(feeds):
            enc[i, :lens[i]] = f['enc']
        return enc, lens

    encs = _encs(np.random.RandomState(2), 2)
    enc, lens = _padded(encs)
    ids_ref, _ = serving.LockstepDecoder(WEIGHTS, K, MAXLEN, SRC,
                                         place=CPU).run(enc, lens)
    kw = dict(page_size=3, pages=12) if paged else {}
    eng = serving.DecodeEngine(WEIGHTS, serving.DecodeConfig(
        slots=2, beam_size=K, max_len=MAXLEN, src_cap=SRC, **kw),
        place=CPU, prefill=prefill)
    try:
        eng.warmup(example_feed={'enc': encs[0]})
        arm['fail'] = 1
        doomed = eng.submit({'enc': encs[0]})
        with pytest.raises(RuntimeError, match='injected prefill fault'):
            doomed.result(60)
        toks, _ = eng.submit({'enc': encs[1]}).result(60)
        assert np.array_equal(toks, ids_ref[1])
        assert len(events('decode.prefill.error')) == 1
        if paged:
            assert eng._hist_pool.free_count == eng._hist_pool.usable
    finally:
        eng.shutdown()


def test_malformed_prefill_fails_only_joiners():
    """tests/test_decode.py:747: a prefill returning too few rows fails
    the joining futures with a clear error, and the engine survives."""
    state = {'short': False}

    def prefill(feeds):
        n = max(0, len(feeds) - 1) if state['short'] else len(feeds)
        return (np.zeros((n, SRC, D), np.float32), np.full(n, 2, np.int32))

    eng = serving.DecodeEngine(WEIGHTS, serving.DecodeConfig(
        slots=4, beam_size=K, max_len=4, src_cap=SRC), place=CPU,
        prefill=prefill)
    try:
        eng.warmup(example_feed={'x': 0})
        state['short'] = True
        doomed = [eng.submit({'x': i}) for i in range(2)]
        failed = 0
        for f in doomed:
            try:
                f.result(60)
            except ValueError as e:
                assert 'prefill returned' in str(e)
                failed += 1
        assert failed >= 1
        state['short'] = False
        toks, _ = eng.submit({'x': 9}).result(60)
        assert toks.shape == (K, 4)
        with pytest.raises(ValueError, match='example_feed'):
            eng.warmup()
    finally:
        eng.shutdown()


def test_prefill_engine_and_lockstep_default_to_the_card():
    """With no place given both run on the card, and raise without one."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present: the no-card contract does not '
                    'apply')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        serving.LockstepDecoder(WEIGHTS, K, MAXLEN, SRC)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        serving.DecodeEngine(WEIGHTS, serving.DecodeConfig(
            slots=2, beam_size=K, max_len=MAXLEN, src_cap=SRC),
            prefill=lambda feeds: None)
