"""The port's token streaming (serving/decode.py on_token, cancel,
checkpoint and resume; serving/router.py Router.stream and TokenStream;
obs/trace.py) against the JAX package's, on the CPU, at small sizes: the
machine_translation decoder of seq_to_seq_net(is_generating=True) at emb,
encoder and decoder 16 (encoder rows of 32), vocab 12, its weights taken
from the JAX startup scope with mt_weights in each package (carried into a
port Scope by name); beam 3, max_len 10, src_cap 5.

  * a stream's tokens arrive t = 1..n once each and in order, its result
    equals the same request's submit() in the port, and the streamed rows
    and scores equal the JAX engine's (tokens equal; scores within
    1e-5 (1 + |s|)), dense, paged and bundled;
  * a stream cancelled after 3 tokens, and one whose on_token raises, free
    their slot and pages, and a fresh request then decodes to its limit;
    a queued request's cancel fails it at once;
  * a checkpoint has the JAX engine's keys, shapes and dtypes (dense,
    paged, speculative with a weights draft), resumes token-exact in the
    port, and crosses packages both ways; resume's validation messages are
    the JAX engine's; a resume at max_new_tokens resolves at once; a
    raising checkpoint sink does not stop the stream;
  * a streaming dispatch makes one host copy, a plain one what it did
    before;
  * DecodeEngine.push_rows and export_step_program (the step Program loads
    in the JAX package's io.load_inference_model);
  * obs.trace: the JAX tests/test_obs.py trace cases, obs spans joining an
    active trace, the Router's serving.request spans and the stream's
    first-token mark.
"""
import json
import os
import threading
import time

import numpy as np
import pytest

import jax  # noqa: F401  (conftest pins it to the CPU)

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import framework as jframework
from paddle_tpu.fluid import io as jio
from paddle_tpu.fluid import unique_name as junique
from paddle_tpu.fluid.executor import Scope as JScope
from paddle_tpu.models import machine_translation as jmt
from paddle_tpu.serving import decode as jdecode

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import obs
from paddle_tpu_torch import serving
from paddle_tpu_torch.obs import trace
from paddle_tpu_torch.serving import decode as tdecode
from paddle_tpu_torch.serving import router as trouter

CPU = tfluid.CPUPlace()
K, MAXLEN, SRC = 3, 10, 5
LIMIT = 10
TOL = 1e-5
GEN = dict(embedding_dim=16, encoder_size=16, decoder_size=16,
           source_dict_dim=12, target_dict_dim=12, is_generating=True,
           beam_size=K, max_length=MAXLEN)
MODES = {
    'dense': dict(slots=2, beam_size=K, max_len=MAXLEN, src_cap=SRC),
    'paged': dict(slots=2, beam_size=K, max_len=MAXLEN, src_cap=SRC,
                  page_size=3, pages=16),
    'bundled': dict(slots=2, beam_size=K, max_len=MAXLEN, src_cap=SRC,
                    page_size=3, pages=16, bundle=3),
    'spec': dict(slots=2, beam_size=1, max_len=MAXLEN, src_cap=SRC,
                 page_size=3, pages=16, spec_k=3),
}


def _mt_weights():
    """The generating program's decoder weights: mt_weights of the JAX
    startup scope, and of a port Scope loaded with the same arrays by
    name."""
    main, startup = jframework.Program(), jframework.Program()
    with junique.guard(), jframework.program_guard(main, startup):
        jmt.seq_to_seq_net(**GEN)
    jscope = JScope()
    with jfluid.scope_guard(jscope):
        jfluid.Executor(jfluid.CPUPlace()).run(startup)
    init = {n: np.array(v) for n, v in jscope.vars.items()}
    tscope = tfluid.Scope()
    tscope.load_numpy(init, CPU)
    return jdecode.mt_weights(jscope), serving.mt_weights(tscope)


JW, TW = _mt_weights()
D_ENC = int(TW['w_q'].shape[1])
ENC = (np.random.RandomState(3).randn(4, D_ENC) * 0.5).astype(np.float32)
# the speculative engine's weights draft: the target's own weights
DRAFT = TW


def _engine(pkg, mode):
    cfg = MODES[mode]
    draft = DRAFT if 'spec_k' in cfg else None
    if pkg == 'jax':
        return jdecode.DecodeEngine(JW, jdecode.DecodeConfig(**cfg),
                                    draft=draft)
    return tdecode.DecodeEngine(TW, tdecode.DecodeConfig(**cfg), place=CPU,
                                draft=draft)


def _wait(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.01)
    return pred()


def _run_streamed(eng, **kw):
    """(result, [(t, row)], [checkpoint]) of one streamed request with
    checkpoints every 3 tokens."""
    seen, ckpts = [], []
    fut = eng.submit({'enc': ENC}, max_new_tokens=LIMIT,
                     on_token=lambda t, ids: seen.append(
                         (t, np.asarray(ids).copy())),
                     checkpoint=ckpts.append, ckpt_every=3, **kw)
    toks, scores = fut.result(60)
    return (np.asarray(toks), np.asarray(scores)), seen, ckpts


@pytest.fixture(scope='module')
def jax_ref():
    """Per mode: the JAX engine's plain result, its streamed run (rows and
    checkpoints), and its resumes of a given checkpoint (a callable)."""
    out = {}
    engines = {}
    for mode in ('dense', 'paged', 'spec'):
        eng = engines[mode] = _engine('jax', mode)
        plain = eng.submit({'enc': ENC}, max_new_tokens=LIMIT).result(60)
        res, seen, ckpts = _run_streamed(eng)
        out[mode] = dict(plain=(np.asarray(plain[0]),
                                np.asarray(plain[1])),
                         streamed=res, seen=seen, ckpts=ckpts,
                         engine=eng)
    yield out
    for eng in engines.values():
        eng.shutdown()


def _assert_same_decode(got, want):
    assert np.array_equal(got[0], want[0])
    assert (np.abs(got[1] - want[1]) <= TOL * (1 + np.abs(want[1]))).all()


# ---------------------------------------------------------------------------
# streaming against submit and the JAX engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('mode', ['dense', 'paged', 'bundled'])
def test_stream_equals_submit_and_the_jax_stream(mode, jax_ref):
    eng = _engine('port', mode)
    r = trouter.Router(window_s=0.0)
    r.add_model('mt', [eng])
    try:
        plain = eng.submit({'enc': ENC}, max_new_tokens=LIMIT).result(60)
        s = r.stream('mt', {'enc': ENC}, max_new_tokens=LIMIT)
        toks = [(t, ids.copy()) for t, ids in s]
        assert [t for t, _ in toks] == list(range(1, LIMIT + 1))
        got = s.result(10)
        assert np.array_equal(got[0], plain[0])
        assert np.array_equal(got[1], plain[1])
        assert s.ttft_s is not None and s.ttft_s > 0
        assert s.last_t == LIMIT and s.done()
        ref = jax_ref['dense' if mode == 'dense' else 'paged']
        _assert_same_decode(got, ref['plain'])
        assert len(toks) == len(ref['seen'])
        for (t, row), (jt, jrow) in zip(toks, ref['seen']):
            assert t == jt and np.array_equal(row, jrow)
    finally:
        r.shutdown(drain=False)


def test_token_stream_drops_replayed_indices():
    s = trouter.TokenStream('m')
    for t in (1, 2, 2, 1, 3, 3, 4):
        s._on_token(t, np.array([t]))
    assert [t for t, _ in s._buf] == [1, 2, 3, 4]
    assert s.last_t == 4


# ---------------------------------------------------------------------------
# cancel and abort
# ---------------------------------------------------------------------------

def test_cancel_after_three_tokens_frees_slot_and_pages():
    """The JAX tests/test_pod_serving.py:1016 drill in the port."""
    eng = tdecode.DecodeEngine(TW, tdecode.DecodeConfig(
        slots=2, beam_size=1, max_len=64, src_cap=SRC, page_size=4,
        pages=40, prefix_cache=False), place=CPU)
    r = trouter.Router(window_s=0.0)
    r.add_model('mt', [eng])
    try:
        base = eng.stats
        seen = []
        s = r.stream('mt', {'enc': ENC}, max_new_tokens=60)
        for t, ids in s:
            seen.append(t)
            if t >= 3:
                break
        assert s.cancel()
        with pytest.raises(serving.StreamCancelled):
            s.result(20)
        assert seen == [1, 2, 3]
        assert _wait(lambda: eng.stats['slots_occupied'] == 0)
        assert _wait(lambda: eng.stats['pages_free'] == base['pages_free'])
        assert eng.stats['cancelled'] == 1
        assert not s.cancel()          # already done
        ids, scores = r.predict('mt', {'enc': ENC}, timeout=60,
                                max_new_tokens=4)
        assert np.asarray(ids).shape == (1, 4)
    finally:
        r.shutdown(drain=False)


def test_raising_on_token_aborts_the_slot():
    eng = _engine('port', 'paged')
    try:
        seen = []

        def consumer(t, ids):
            seen.append(t)
            if t == 3:
                raise IOError('client went away')

        fut = eng.submit({'enc': ENC}, max_new_tokens=LIMIT,
                         on_token=consumer)
        with pytest.raises(serving.StreamCancelled, match='after 3'):
            fut.result(30)
        assert seen == [1, 2, 3]
        # the history pages back (the encoder pages stay resident in the
        # prefix cache)
        assert _wait(lambda: eng._hist_pool.free_count
                     == eng._hist_pool.usable)
        assert eng.stats['slots_occupied'] == 0
        assert eng.stats['cancelled'] == 1
        toks, _ = eng.submit({'enc': ENC},
                             max_new_tokens=LIMIT).result(30)
        assert toks.shape == (K, LIMIT)
    finally:
        eng.shutdown()


def test_cancel_of_a_queued_request_fails_it_at_once():
    eng = tdecode.DecodeEngine(TW, tdecode.DecodeConfig(
        slots=1, beam_size=K, max_len=64, src_cap=SRC), place=CPU)
    gate = threading.Event()
    try:
        first = eng.submit({'enc': ENC}, max_new_tokens=60,
                           on_token=lambda t, ids: gate.wait(10))
        queued = eng.submit({'enc': ENC}, max_new_tokens=4)
        assert eng.cancel(queued)
        with pytest.raises(serving.StreamCancelled, match='queued'):
            queued.result(1)
        gate.set()
        first.result(60)
        assert not eng.cancel(first)
        assert not eng.cancel(queued)
    finally:
        gate.set()
        eng.shutdown()


# ---------------------------------------------------------------------------
# checkpoint and resume
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('mode', ['dense', 'paged', 'spec'])
def test_checkpoint_has_the_jax_keys_shapes_and_dtypes(mode, jax_ref):
    eng = _engine('port', mode)
    try:
        res, seen, ckpts = _run_streamed(eng)
    finally:
        eng.shutdown()
    ref = jax_ref[mode]
    _assert_same_decode(res, ref['streamed'])
    assert [t for t, _ in seen] == list(range(1, LIMIT + 1))
    steps = [int(c['step']) for c in ckpts]
    # a speculative dispatch emits up to spec_k + 1 tokens: the checkpoint
    # falls at the dispatch that crosses the cadence
    assert steps == ([4, 8] if mode == 'spec' else [3, 6, 9])
    assert steps == [int(c['step']) for c in ref['ckpts']]
    for got, want in zip(ckpts, ref['ckpts']):
        assert sorted(got) == sorted(want)
        for k in want:
            w = np.asarray(want[k])
            assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
            if w.dtype.kind == 'f':
                np.testing.assert_allclose(got[k], w, rtol=TOL, atol=TOL)
            else:
                assert np.array_equal(got[k], w), k


@pytest.mark.parametrize('mode', ['dense', 'paged', 'spec'])
def test_resume_is_token_exact_within_the_port(mode):
    eng = _engine('port', mode)
    try:
        want, _, ckpts = _run_streamed(eng)
        for c in ckpts:
            seen = []
            got = eng.submit({'enc': ENC}, max_new_tokens=LIMIT, resume=c,
                             on_token=lambda t, ids: seen.append(t)
                             ).result(60)
            assert np.array_equal(got[0], want[0])
            assert np.array_equal(got[1], want[1])
            assert seen == list(range(int(c['step']) + 1, LIMIT + 1))
        assert eng.stats['resumed'] == len(ckpts)
    finally:
        eng.shutdown()


@pytest.mark.parametrize('mode', ['dense', 'paged', 'spec'])
def test_a_jax_checkpoint_resumes_in_the_port(mode, jax_ref):
    ref = jax_ref[mode]
    eng = _engine('port', mode)
    try:
        for c in ref['ckpts']:
            got = eng.submit({'enc': ENC}, max_new_tokens=LIMIT,
                             resume=c).result(60)
            _assert_same_decode(got, ref['streamed'])
    finally:
        eng.shutdown()


@pytest.mark.parametrize('mode', ['dense', 'paged', 'spec'])
def test_a_port_checkpoint_resumes_in_the_jax_engine(mode, jax_ref):
    ref = jax_ref[mode]
    eng = _engine('port', mode)
    try:
        _, _, ckpts = _run_streamed(eng)
    finally:
        eng.shutdown()
    for c in ckpts:
        got = ref['engine'].submit({'enc': ENC}, max_new_tokens=LIMIT,
                                   resume=c).result(60)
        _assert_same_decode((np.asarray(got[0]), np.asarray(got[1])),
                            ref['streamed'])


def _submit_errors(eng, ckpt):
    bad = [dict(on_token=3), dict(checkpoint='sink'),
           dict(resume={k: v for k, v in ckpt.items() if k != 'h'}),
           dict(resume=dict(ckpt, step=np.int32(LIMIT + 1))),
           dict(resume=dict(ckpt, step=np.int32(-1))),
           dict(resume=dict(ckpt, ids=ckpt['ids'][:-1])),
           dict(resume=dict(ckpt, par=np.zeros((3, K + 1), np.int32)))]
    out = []
    for kw in bad:
        with pytest.raises(ValueError) as e:
            eng.submit({'enc': ENC}, max_new_tokens=LIMIT, **kw)
        out.append(str(e.value))
    return out


def test_resume_validation_is_the_jax_validation(jax_ref):
    ckpt = jax_ref['dense']['ckpts'][0]
    eng = _engine('port', 'dense')
    try:
        got = _submit_errors(eng, ckpt)
    finally:
        eng.shutdown()
    want = _submit_errors(jax_ref['dense']['engine'], ckpt)
    assert got == want


def test_a_resume_at_the_limit_resolves_at_once(jax_ref):
    ref = jax_ref['dense']
    eng = _engine('port', 'dense')
    try:
        _, _, ckpts = _run_streamed(eng)
        c = ckpts[-1]
        n = int(c['step'])
        fut = eng.submit({'enc': ENC}, max_new_tokens=n, resume=c)
        assert fut.done()
        got = fut.result()
        want = ref['engine'].submit({'enc': ENC}, max_new_tokens=n,
                                    resume=c).result(10)
        assert np.array_equal(got[0], np.asarray(want[0]))
        assert np.array_equal(got[1], np.asarray(want[1]))
        assert got[0].shape == (K, n) and got[0].dtype == np.int64
        assert eng.stats['joins'] == 1      # took no slot
    finally:
        eng.shutdown()


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


def test_a_raising_checkpoint_sink_does_not_stop_the_stream(events):
    eng = _engine('port', 'paged')
    try:
        want = eng.submit({'enc': ENC}, max_new_tokens=LIMIT).result(60)
        seen = []

        def sink(state):
            raise IOError('disk full')

        got = eng.submit({'enc': ENC}, max_new_tokens=LIMIT,
                         on_token=lambda t, ids: seen.append(t),
                         checkpoint=sink, ckpt_every=3).result(60)
    finally:
        eng.shutdown()
    assert np.array_equal(got[0], want[0])
    assert seen == list(range(1, LIMIT + 1))
    errs = events('decode.ckpt.error')
    assert [e['fields']['step'] for e in errs] == [3, 6, 9]
    assert 'disk full' in errs[0]['fields']['error']


@pytest.mark.parametrize('mode', ['paged', 'bundled'])
def test_a_streaming_dispatch_makes_one_host_copy(mode):
    eng = _engine('port', mode)
    try:
        eng.warmup()
        s0 = eng.stats
        eng.submit({'enc': ENC}, max_new_tokens=LIMIT).result(60)
        s1 = eng.stats
        # plain: one copy a dispatch, three more where a slot releases
        assert s1['host_syncs'] - s0['host_syncs'] \
            == s1['steps'] - s0['steps'] + 3
        _run_streamed(eng)
        s2 = eng.stats
        assert s2['host_syncs'] - s1['host_syncs'] \
            == s2['steps'] - s1['steps']
    finally:
        eng.shutdown()


# ---------------------------------------------------------------------------
# push_rows and export_step_program
# ---------------------------------------------------------------------------

def test_decode_push_rows_reaches_the_next_dispatch(jax_ref):
    rng = np.random.RandomState(5)
    ids = np.array([0, 4, 7, 11])     # 0: the start id, read by every step
    rows = (rng.randn(4, TW['w_emb'].shape[1]) * 0.5).astype(np.float32)
    pushed = dict(TW, w_emb=TW['w_emb'].copy())
    pushed['w_emb'][ids] = rows
    fresh = tdecode.DecodeEngine(pushed, tdecode.DecodeConfig(
        **MODES['paged']), place=CPU)
    eng = _engine('port', 'paged')
    try:
        want = fresh.submit({'enc': ENC}, max_new_tokens=LIMIT).result(60)
        before = eng.submit({'enc': ENC}, max_new_tokens=LIMIT).result(60)
        assert eng.push_rows({'cbd_w_emb': (ids, rows)}) == 4
        got = eng.submit({'enc': ENC}, max_new_tokens=LIMIT).result(60)
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])
        assert not np.array_equal(before[1], got[1])
        assert eng.stats['delta_pushes'] == 1
        assert eng.stats['delta_rows'] == 4
        with pytest.raises(serving.DeltaUnsupported, match='cbd_h'):
            eng.push_rows({'cbd_h': (np.array([0]),
                                     np.zeros((1, K, 16), np.float32))})
        with pytest.raises(KeyError, match='cbd_nope'):
            eng.push_rows({'cbd_nope': (ids, rows)})
        with pytest.raises(ValueError, match='out of range'):
            eng.push_rows({'cbd_w_emb': (np.array([99]), rows[:1])})
        # the JAX engine given the same push decodes the same tokens
        jeng = jax_ref['paged']['engine']
        jeng.push_rows({'cbd_w_emb': (ids, rows)})
        jgot = jeng.submit({'enc': ENC}, max_new_tokens=LIMIT).result(60)
        _assert_same_decode(got, (np.asarray(jgot[0]),
                                  np.asarray(jgot[1])))
        jeng.push_rows({'cbd_w_emb': (ids, JW['w_emb'][ids])})
    finally:
        eng.shutdown()
        fresh.shutdown()
    eng.shutdown()
    with pytest.raises(serving.ServerClosed):
        eng.push_rows({'cbd_w_emb': (ids, rows)})


def test_export_step_program_loads_in_the_jax_package(tmp_path):
    eng = _engine('port', 'paged')
    try:
        eng.submit({'enc': ENC}, max_new_tokens=4).result(60)
        out = eng.export_step_program(str(tmp_path / 'step'))
        state = {n: t.detach().numpy().copy()
                 for n, t in eng._acquire().state.items()}
    finally:
        eng.shutdown()
    assert out == str(tmp_path / 'step')
    jscope = JScope()
    with jfluid.scope_guard(jscope):
        prog, feeds, fetches = jio.load_inference_model(
            out, jfluid.Executor(jfluid.CPUPlace()))
    assert feeds == []
    assert [op.type for op in prog.global_block().ops] == \
        ['attention_lstm_beam_paged_step']
    assert [v.name for v in fetches] == [
        'cbd_active', 'cbd_hist_ids', 'cbd_hist_par', 'cbd_acc', 'cbd_step']
    for n, a in state.items():
        assert np.array_equal(np.asarray(jscope.vars[n]), a), n


# ---------------------------------------------------------------------------
# obs.trace
# ---------------------------------------------------------------------------

@pytest.fixture
def fresh_trace():
    trace._reset()
    yield
    trace._reset()


def test_trace_context_headers_roundtrip_and_span_linkage(fresh_trace):
    ctx = trace.new_trace()
    assert len(ctx.trace_id) == 16
    with trace.activate(ctx, node='router'):
        assert trace.current().trace_id == ctx.trace_id
        far = trace.from_headers(json.loads(json.dumps(trace.headers())))
        assert far.trace_id == ctx.trace_id
        h = trace.begin('t.tr.parent', node='router')
        child = trace.begin('t.tr.child', ctx=h.ctx, node='h0')
        child.mark('t.tr.milestone', k=1)
        child.end()
        h.end(ok=True)
    assert trace.current() is None
    assert trace.from_headers(None) is None
    assert trace.from_headers({'nope': 1}) is None
    assert trace.from_headers('junk') is None
    assert trace.begin('t.tr.orphanless') is None
    assert trace.mark('t.tr.nomark') is None
    recs = {r['name']: r for r in trace._buf}
    assert recs['t.tr.child']['parent'] == recs['t.tr.parent']['span']
    assert recs['t.tr.milestone']['parent'] == recs['t.tr.child']['span']
    assert recs['t.tr.parent']['fields'] == {'ok': True}


def test_trace_spill_and_collector_stitch_with_orphan(tmp_path, fresh_trace):
    tdir = str(tmp_path / 'traces')
    ctx = trace.new_trace()
    with trace.activate(ctx, node='router'):
        req = trace.begin('serving.request', node='router', uid=7)
        time.sleep(0.002)
        srv = trace.begin('serving.pod.serve', ctx=req.ctx, node='h0')
        srv.mark('trace.dispatch')
        time.sleep(0.002)
        srv.mark('trace.first_token', server_ttft_s=0.002)
        time.sleep(0.002)
        srv.end()
        req.end()
    assert trace.spill(tdir) is not None
    dead = {'pid': 99999, 'spans': [
        {'trace': ctx.trace_id, 'span': 'feedfeedfeedfeed',
         'parent': None, 'name': 'serving.pod.serve', 'node': 'h1',
         'pid': 99999, 't0': time.time(), 't1': None, 'fields': {}}]}
    with open(os.path.join(tdir, 'spans.p99999.json'), 'w') as f:
        json.dump(dead, f)
    tl = trace.TraceCollector(tdir).timeline(ctx.trace_id)
    assert set(tl['nodes']) == {'router', 'h0', 'h1'}
    assert [o['node'] for o in tl['orphans']] == ['h1']
    points = {m['name']: m['t'] for m in tl['milestones']}
    for a, b in (('admit', 'serve'), ('serve', 'dispatch'),
                 ('dispatch', 'first_token'), ('first_token', 'done')):
        assert points[a] <= points[b], (a, b, points)
    assert 'dispatch->first_token' in [st['stage'] for st in tl['stages']]


def test_trace_buffer_bounded_counts_drops(fresh_trace):
    trace.set_capacity(32)
    try:
        ctx = trace.new_trace()
        before = obs.REGISTRY.total('obs.trace.dropped') or 0
        for i in range(100):
            trace.begin('t.tr.flood', ctx=ctx, i=i).end()
        dropped = (obs.REGISTRY.total('obs.trace.dropped') or 0) - before
        assert dropped >= 100 - 32
        assert len(trace._buf) <= 32
    finally:
        trace.set_capacity(trace._DEFAULT_CAPACITY)


def test_obs_spans_and_events_join_an_active_trace(events, fresh_trace):
    ctx = trace.new_trace()
    with trace.activate(ctx, node='router'):
        with obs.span('t.outer'):
            with obs.span('t.inner', k=2):
                obs.event('t.ev', x=1)
    with obs.span('t.untraced'):
        pass
    recs = {r['name']: r for r in trace._buf}
    assert set(recs) == {'t.outer', 't.inner'}
    assert recs['t.inner']['parent'] == recs['t.outer']['span']
    assert recs['t.inner']['fields'] == {'k': 2}
    ev, = events('t.ev')
    assert ev['trace'] == ctx.trace_id
    assert ev['tspan'] == recs['t.inner']['span']
    path = obs.run_log_path()
    with open(path) as f:
        spans = {r['name']: r for r in map(json.loads, f)
                 if r['kind'] == 'span'}
    assert spans['t.inner']['tparent'] == recs['t.outer']['span']
    assert 'trace' not in spans['t.untraced']


def test_router_requests_are_traced(fresh_trace):
    eng = _engine('port', 'paged')
    r = trouter.Router(window_s=0.0)
    r.add_model('mt', [eng])
    try:
        r.predict('mt', {'enc': ENC}, max_new_tokens=3, timeout=60)
        s = r.stream('mt', {'enc': ENC}, max_new_tokens=3)
        s.result(60)
        assert _wait(lambda: sum(rec['name'] == 'serving.request'
                                 for rec in trace._buf) == 2)
        reqs = [rec for rec in trace._buf
                if rec['name'] == 'serving.request']
        assert all(rec['node'] == 'router' and rec['t1'] is not None
                   and rec['fields']['model'] == 'mt' for rec in reqs)
        assert _wait(lambda: 'tokens' in reqs[1]['fields'])
        assert reqs[1]['fields']['tokens'] == 3
        first = [rec for rec in trace._buf
                 if rec['name'] == 'trace.first_token']
        assert len(first) == 1 and first[0]['parent'] == reqs[1]['span']
        with pytest.raises(trouter.UnknownModel):
            r.submit('nope', {'enc': ENC})
        assert trace.current() is None
    finally:
        r.shutdown(drain=False)
