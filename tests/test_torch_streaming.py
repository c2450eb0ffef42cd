"""The port's online training with live serving freshness (streaming/,
serving/router.py, ServingEngine.push_rows, Trainer.train_stream) against
the JAX package's, on the CPU, at small sizes: a sparse DeepFM of 4 fields,
vocab 32, embed_dim 4, hidden [8] (Adam), and the JAX tests/test_streaming.py
net (3 ids into a [13, 4] table and an fc).

  * RefCountedLRU, VocabTable (admission, cold row, LRU eviction, pins,
    preload, forced evict, state_dict) over one seeded drifting stream:
    equal rows, evictions, resets, state_dict and stats in both packages,
    the typed failures with the JAX messages, a state_dict loading in the
    other package; table_state_names equal on both programs; RowResetter
    equal to the JAX one and in place; the int8 row codec bitwise;
  * ServingEngine.push_rows: the JAX validation messages, DeltaUnsupported
    for a scope-less model and for a persistable the program writes, the
    pushed answer equal to the JAX engine's (1e-6), the rows written into
    the tensors the scope holds (no rebind), pushes racing traffic never
    torn; predict's timeout, cancel, request_shutdown, stats_window,
    per_row_outputs and max_retries as in the JAX engine;
  * Router: least-loaded dispatch and quotas over scripted replicas, the
    same routing decisions as the JAX Router; push_deltas to every
    replica, racing swap(builder=), all replicas closed;
    estimate_state_bytes, not ported, raises NotImplementedError;
  * DeltaPublisher: cadence, retention on failure, the int8 wire, the
    same deltas as the JAX publisher;
  * Trainer.train_stream on a drifting Zipf stream from weights carried
    across (Scope.load_numpy): losses, every persistable (tables and Adam
    moments) and the pushed deltas within 1e-5 of the JAX train_stream's,
    the vocab state equal, with double_buffer off and on; an identity
    vocab bitwise the plain loop; a stream serial written by either
    package resumes in the other with the same map and state bitwise;
    the wall-clock cadence, preemption and the refused modes; the end to
    end loop into two Router replicas.
"""
import concurrent.futures
import os
import threading
import time
import warnings

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (conftest pins it to the CPU)

import paddle_tpu.fluid as jfluid
from paddle_tpu import streaming as jstreaming
from paddle_tpu.embedding import quant_rows as jquant
from paddle_tpu.fluid import framework as jframework
from paddle_tpu.fluid import unique_name as junique
from paddle_tpu.inference import Predictor as JPredictor
from paddle_tpu.models import deepfm as jdeepfm
from paddle_tpu.serving import engine as jengine
from paddle_tpu.serving import router as jrouter
from paddle_tpu.utils.lru import RefCountedLRU as JLRU

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch import streaming as tstreaming
from paddle_tpu_torch.embedding import quant_rows as tquant
from paddle_tpu_torch.fluid import framework as tframework
from paddle_tpu_torch.fluid import unique_name as tunique
from paddle_tpu_torch.inference import Predictor as TPredictor
from paddle_tpu_torch.models import deepfm as tdeepfm
from paddle_tpu_torch.serving import engine as tengine
from paddle_tpu_torch.serving import pages as tpages
from paddle_tpu_torch.serving import router as trouter
from paddle_tpu_torch.utils.lru import RefCountedLRU as TLRU

PKG = {
    'jax': dict(fluid=jfluid, framework=jframework, unique=junique,
                streaming=jstreaming, deepfm=jdeepfm, engine=jengine,
                router=jrouter, Predictor=JPredictor),
    'port': dict(fluid=tfluid, framework=tframework, unique=tunique,
                 streaming=tstreaming, deepfm=tdeepfm, engine=tengine,
                 router=trouter, Predictor=TPredictor),
}
FIELDS, VOCAB, DIM = 4, 32, 4
SMALL = dict(num_fields=FIELDS, vocab_size=VOCAB, embed_dim=DIM, hidden=[8])
# the two packages sum in other orders (the sparse merge, two libraries'
# products): 1e-5, as tests/test_torch_deepfm.py holds the same model
TOL = 1e-5
CAP, NET_DIM, NET_FIELDS = 13, 4, 3     # the JAX test_streaming.py net


def _np(v):
    return np.array(v.detach().cpu() if isinstance(v, torch.Tensor) else v)


# ---------------------------------------------------------------------------
# the refcounted LRU
# ---------------------------------------------------------------------------

def _lru_script(lru):
    out = []
    for k in 'abcde':
        lru.insert(k, k.upper())
    lru.touch('a')
    out.append(lru.evict_one())
    lru.ref('c')
    lru.ref('d')
    out.append(lru.evict_one())
    out.append((lru.evictable(), lru.evictable(lambda v: 2), lru.refs('c')))
    lru.unref('c')
    lru.unref('c')
    lru.unref('zz')
    out.append((lru.refs('c'), len(lru), 'a' in lru, lru.get('q')))
    out.append(lru.pop('d'))
    out.append(lru.items())
    out.append(lru.evict_one())
    out.append(lru.evict_one())
    out.append(lru.evict_one())
    try:
        lru.insert('x', 1)
        lru.insert('x', 2)
    except KeyError as e:
        out.append(('KeyError', str(e)))
    return out


def test_refcounted_lru_is_the_jax_structure_and_pages_share_it():
    assert _lru_script(TLRU()) == _lru_script(JLRU())
    assert tpages.RefCountedLRU is TLRU
    assert type(tpages.PrefixCache(tpages.PagePool(8))._lru) is TLRU


# ---------------------------------------------------------------------------
# VocabTable over one seeded drifting stream
# ---------------------------------------------------------------------------

def _drift_batches(n, batch=16, fields=FIELDS, seed=0, step=3):
    """The JAX bench's drifting Zipf(1.5) stream over a 2^30 universe."""
    rng = np.random.RandomState(seed)
    return [((t * step + rng.zipf(1.5, size=(batch, fields))) % (1 << 30))
            .astype('int64') for t in range(n)]


def _vocab_run(pkg, capacity, admit_count, cold_row, max_pending):
    """Translate a drifting stream with one batch in flight (the lease of
    batch t released after batch t+1 is translated), with a preload and a
    forced evict on the way; returns every observable after each step."""
    st = PKG[pkg]['streaming']
    vt = st.VocabTable(capacity, table='w', admit_count=admit_count,
                       cold_row=cold_row, max_pending=max_pending)
    vt.preload([7, 8, 9])
    out, prev = [], None
    for t, ids in enumerate(_drift_batches(12)):
        try:
            rows, lease = vt.translate(ids)
        except st.VocabFull as e:     # no cold row: every row pinned
            out.append(('VocabFull', str(e)))
            break
        if prev is not None:
            prev.release()
        prev = lease
        if t == 5:
            victim = vt.resident_ids()[0]
            try:
                out.append(('evict', vt.evict(victim)))
            except Exception as e:
                out.append(('evict', type(e).__name__))
        out.append((rows.tolist(), vt.drain_resets(), vt.stats(),
                    vt.resident_ids(), vt.rows_of(ids[:2]).tolist(),
                    vt.lookup(ids[:1]).tolist() if cold_row is not None
                    else None))
    prev.release()
    return out, vt.state_dict()


@pytest.mark.parametrize('capacity,admit_count,cold_row,max_pending', [
    (24, 2, 0, None), (40, 1, 5, None), (24, 3, 0, 8), (90, 1, None, None),
    (40, 1, None, None)])
def test_vocab_table_matches_jax_on_a_drifting_stream(
        capacity, admit_count, cold_row, max_pending):
    got = _vocab_run('port', capacity, admit_count, cold_row, max_pending)
    want = _vocab_run('jax', capacity, admit_count, cold_row, max_pending)
    assert got == want
    if capacity == 40 and cold_row is None:
        assert got[0][-1][0] == 'VocabFull'
    else:
        assert got[0][-1][2]['rows_evicted'] > 0


def _typed_failures(pkg):
    st = PKG[pkg]['streaming']
    out = []
    vt = st.VocabTable(4, table='w', admit_count=1)
    rows, lease = vt.translate([1, 2, 3])
    r4, l4 = vt.translate([4, 4])
    out.append((r4.tolist(), vt.deferred))
    for bad in (1, 999):
        try:
            vt.evict(bad)
        except (st.RowPinned, KeyError) as e:
            out.append((type(e).__name__, str(e)))
    lease.release()
    l4.release()
    vt2 = st.VocabTable(2, table='w', admit_count=1, cold_row=None)
    _, l2 = vt2.translate([1, 2])
    try:
        vt2.translate([3])
    except st.VocabFull as e:
        out.append(('VocabFull', str(e)))
    try:
        vt2.lookup([77])
    except KeyError as e:
        out.append(('KeyError', str(e)))
    try:
        vt2.preload([5])
    except st.VocabFull as e:
        out.append(('VocabFull', str(e)))
    for kw in (dict(capacity=1), dict(capacity=4, admit_count=0),
               dict(capacity=4, cold_row=9)):
        try:
            st.VocabTable(**kw)
        except ValueError as e:
            out.append(('ValueError', str(e)))
    try:
        st.VocabTable(5, table='w').load_state_dict(vt.state_dict())
    except ValueError as e:
        out.append(('ValueError', str(e)))
    with vt.translate([1])[1] as lease3:
        out.append(lease3 is not None)
    out.append(len(vt))
    return out


def test_vocab_typed_failures_carry_the_jax_messages():
    assert _typed_failures('port') == _typed_failures('jax')


@pytest.mark.parametrize('writer,reader', [('jax', 'port'), ('port', 'jax')])
def test_vocab_state_dict_loads_in_the_other_package(writer, reader):
    a = PKG[writer]['streaming'].VocabTable(20, table='w', admit_count=2)
    for ids in _drift_batches(6):
        a.translate(ids, pin=False)
    b = PKG[reader]['streaming'].VocabTable(20, table='w', admit_count=2)
    b.load_state_dict(a.state_dict())
    assert b.state_dict() == a.state_dict()
    assert b.resident_ids() == a.resident_ids()
    for ids in _drift_batches(3, seed=1):
        ra, _ = a.translate(ids, pin=False)
        rb, _ = b.translate(ids, pin=False)
        np.testing.assert_array_equal(ra, rb)
    assert a.drain_resets() == b.drain_resets()


# ---------------------------------------------------------------------------
# program-side helpers: table_state_names, RowResetter, the row codec
# ---------------------------------------------------------------------------

def _net(fluid, seed=7):
    """The JAX tests/test_streaming.py scorer: 3 ids into a [13, 4] sparse
    table, an fc, summed over the fields."""
    fluid.default_main_program().random_seed = seed
    fluid.default_startup_program().random_seed = seed
    ids = fluid.layers.data(name='ids', shape=[NET_FIELDS, 1], dtype='int64')
    label = fluid.layers.data(name='label', shape=[1], dtype='float32')
    emb = fluid.layers.embedding(ids, size=[CAP, NET_DIM], is_sparse=True,
                                 param_attr=fluid.ParamAttr(name='emb_w'))
    pred = fluid.layers.fc(input=emb, size=1, num_flatten_dims=2,
                           param_attr=fluid.ParamAttr(name='fc_w'))
    score = fluid.layers.reduce_sum(pred, dim=1)
    loss = fluid.layers.mean(fluid.layers.square(score - label))
    return ids, label, score, loss


_OPTS = {
    'adam': lambda f: f.optimizer.Adam(learning_rate=0.1),
    'adagrad': lambda f: f.optimizer.Adagrad(learning_rate=0.1),
    'momentum': lambda f: f.optimizer.Momentum(learning_rate=0.1,
                                               momentum=0.9),
    'sgd': lambda f: f.optimizer.SGD(learning_rate=0.1),
}


@pytest.mark.parametrize('opt', sorted(_OPTS))
def test_table_state_names_are_the_jax_names(opt):
    got = {}
    for pkg in ('jax', 'port'):
        p = PKG[pkg]
        main, startup = p['framework'].Program(), p['framework'].Program()
        with p['unique'].guard(), p['framework'].program_guard(main,
                                                               startup):
            loss = _net(p['fluid'])[3]
            _OPTS[opt](p['fluid']).minimize(loss)
        got[pkg] = p['streaming'].table_state_names(main, 'emb_w')
        with pytest.raises(KeyError):
            p['streaming'].table_state_names(main, 'nope')
    assert got['port'] == got['jax']
    assert got['port'][0] == 'emb_w'
    assert len(got['port']) == {'adam': 3, 'adagrad': 2, 'momentum': 2,
                                'sgd': 1}[opt]


def test_deepfm_table_state_names_are_the_jax_names():
    got = {}
    for pkg in ('jax', 'port'):
        p = PKG[pkg]
        main, startup = p['framework'].Program(), p['framework'].Program()
        with p['unique'].guard(), p['framework'].program_guard(main,
                                                               startup):
            p['fluid'].optimizer.Adam(learning_rate=1e-3).minimize(
                _deepfm_train_func(pkg)()[0])
        got[pkg] = [p['streaming'].table_state_names(main, t)
                    for t in ('fm_embed', 'fm_first_w')]
    assert got['port'] == got['jax']
    assert got['port'][0] == ['fm_embed', 'moment1_fm_embed_0',
                              'moment2_fm_embed_0']


@pytest.mark.parametrize('rows', [[1, 3], [0], [4, 4, 2, 0, 1, 3, 2],
                                  [], [9, 9]])
def test_row_resetter_zeroes_in_place_like_jax(rows):
    rng = np.random.RandomState(3)
    arrays = [rng.randn(10, 4).astype('float32') + 1.0,
              rng.randn(10, 4).astype('float32') + 1.0,
              rng.randn(10, 1).astype('float32') + 1.0]
    want = jstreaming.RowResetter().reset(
        [jax.numpy.asarray(a) for a in arrays], rows, batch=4)
    tensors = [torch.from_numpy(a.copy()) for a in arrays]
    ptrs = [t.data_ptr() for t in tensors]
    rr = tstreaming.RowResetter()
    got = rr.reset(tensors, rows, lock=threading.RLock())
    assert [t.data_ptr() for t in got] == ptrs
    assert all(g is t for g, t in zip(got, tensors))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(TypeError, match='in place'):
        rr.reset([arrays[0]], [1])


def test_row_codec_is_the_jax_codec():
    rng = np.random.RandomState(5)
    vals = (rng.randn(7, 10) * rng.rand(7, 1) * 3).astype('float32')
    vals[2] = 0.0
    jq, js = jquant.quantize_rows(vals)
    tq, ts = tquant.quantize_rows(vals)
    np.testing.assert_array_equal(tq, jq)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(tquant.dequantize_rows(tq, ts),
                                  jquant.dequantize_rows(jq, js))
    assert tquant.row_bytes(tq, ts) == jquant.row_bytes(jq, js) == 7 * 14


# ---------------------------------------------------------------------------
# ServingEngine: push_rows and the rest of the JAX surface
# ---------------------------------------------------------------------------

def _serve_dir(pkg, root, deepfm=False):
    """Save a scorer from its startup state: the JAX test net's score, or
    the small DeepFM's prob (a sparse-table model, both FM tables)."""
    p = PKG[pkg]
    fluid = p['fluid']
    main, startup = p['framework'].Program(), p['framework'].Program()
    sc = fluid.Scope()
    d = os.path.join(str(root), 'serve_%s_%s' % (pkg, 'deepfm' if deepfm
                                                  else 'net'))
    with p['unique'].guard(), p['framework'].program_guard(main, startup):
        if deepfm:
            feat = fluid.layers.data(name='feat_ids', shape=[FIELDS],
                                     dtype='int64')
            label = fluid.layers.data(name='label', shape=[1],
                                      dtype='int64')
            _, out, _ = p['deepfm'].deepfm(feat, label, is_sparse=True,
                                           **SMALL)
            feeds = ['feat_ids']
        else:
            out = _net(fluid)[2]
            feeds = ['ids']
        with fluid.scope_guard(sc):
            exe = fluid.Executor(fluid.CPUPlace())
            exe.run(startup)
            fluid.io.save_inference_model(d, feeds, [out], exe,
                                          main_program=main)
    return d


def _engine(pkg, d, buckets=(4,), **kw):
    p = PKG[pkg]
    pred = p['Predictor'](d) if pkg == 'jax' else \
        p['Predictor'](d, place=tfluid.CPUPlace())
    return p['engine'].ServingEngine(pred, p['engine'].ServingConfig(
        max_batch_size=max(buckets), buckets=list(buckets)), **kw)


def _probe(ids_rows):
    return {'ids': np.asarray(ids_rows, 'int64').reshape(1, NET_FIELDS, 1)}


class _Bare(object):
    feed_names = ['ids']

    def run(self, feed):
        return [np.zeros((feed['ids'].shape[0], 1), np.float32)]


class _Writes(object):
    """A model whose program writes emb_w (the training program): the
    write set that push_rows refuses."""

    def __init__(self, pkg):
        p = PKG[pkg]
        main, startup = p['framework'].Program(), p['framework'].Program()
        with p['unique'].guard(), p['framework'].program_guard(main,
                                                               startup):
            _OPTS['adam'](p['fluid']).minimize(_net(p['fluid'])[3])
        self._program = main
        self._scope = p['fluid'].Scope()
        self._exe = p['fluid'].Executor(p['fluid'].CPUPlace())
        with p['fluid'].scope_guard(self._scope):
            self._exe.run(startup)
        self.feed_names = ['ids']

    def run(self, feed):
        return [np.zeros((feed['ids'].shape[0], 1), np.float32)]


def _push_errors(pkg, d):
    eng_mod = PKG[pkg]['engine']
    out = []
    rows = np.array([1, 2, 3])
    vals = np.full((3, NET_DIM), 5.0, np.float32)
    bad = [{'nope': (rows, vals)},
           {'emb_w': (np.array([CAP + 3]), np.zeros((1, NET_DIM),
                                                    np.float32))},
           {'emb_w': (np.array([-1]), np.zeros((1, NET_DIM), np.float32))},
           {'emb_w': (rows, np.zeros((3, NET_DIM + 1), np.float32))},
           {'emb_w': (rows.reshape(3, 1), vals)},
           {'emb_w': (rows.astype('float32'), vals)},
           {'emb_w': (rows, vals.astype(np.complex64))}]
    with _engine(pkg, d) as eng:
        for deltas in bad:
            with pytest.raises((KeyError, ValueError)) as e:
                eng.push_rows(deltas)
            out.append((e.type.__name__, str(e.value)))
        out.append(eng.stats['delta_pushes'])
    for model in (_Bare(), _Writes(pkg)):
        with eng_mod.ServingEngine(model, eng_mod.ServingConfig(
                max_batch_size=4, buckets=[4])) as other:
            with pytest.raises(eng_mod.DeltaUnsupported) as e:
                other.push_rows({'emb_w': (rows, vals)})
            out.append(type(model).__name__)
    eng = _engine(pkg, d)
    eng.shutdown()
    with pytest.raises(eng_mod.ServerClosed):
        eng.push_rows({'emb_w': (rows, vals)})
    return out


def test_push_rows_validation_is_the_jax_validation(tmp_path):
    got = _push_errors('port', _serve_dir('port', tmp_path))
    want = _push_errors('jax', _serve_dir('jax', tmp_path))
    assert got == want
    assert issubclass(tengine.DeltaUnsupported, TypeError)


def test_push_rows_writes_in_place_and_answers_like_jax(tmp_path):
    tdir, jdir = _serve_dir('port', tmp_path), _serve_dir('jax', tmp_path)
    rng = np.random.RandomState(2)
    with _engine('port', tdir) as teng, _engine('jax', jdir) as jeng:
        # the same weights on both sides: the JAX replica's scope carried
        # into the port's
        teng._model._scope.load_numpy(
            {n: np.asarray(v) for n, v in jeng._model._scope.vars.items()},
            tfluid.CPUPlace())
        table = teng._model._scope.vars['emb_w']
        before = teng.predict(_probe([1, 2, 3]))[0]
        for gen in range(3):
            ids = rng.choice(CAP, size=5, replace=False)
            vals = rng.randn(5, NET_DIM).astype('float64')   # cast on push
            assert teng.push_rows({'emb_w': (ids, vals)}) == 5
            assert jeng.push_rows({'emb_w': (ids, vals)}) == 5
            assert teng._model._scope.vars['emb_w'] is table
            for probe in ([1, 2, 3], ids[:3].tolist()):
                np.testing.assert_allclose(
                    teng.predict(_probe(probe))[0],
                    np.asarray(jeng.predict(_probe(probe))[0]),
                    rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(
            table.numpy(), np.asarray(jeng._model._scope.vars['emb_w']),
            rtol=0, atol=1e-6)
        assert not np.allclose(before, teng.predict(_probe([1, 2, 3]))[0])
        assert teng.stats['delta_pushes'] == jeng.stats['delta_pushes'] == 3
        assert teng.stats['delta_rows'] == jeng.stats['delta_rows'] == 15


def test_pushes_racing_traffic_are_never_torn(tmp_path):
    """Every push writes generation g into the probe's rows of BOTH FM
    tables of a DeepFM scorer; each answer the traffic thread reads must be
    bitwise the answer of one whole generation (computed alone after), so
    no batch saw one table pushed and the other not."""
    d = _serve_dir('port', tmp_path, deepfm=True)
    probe = {'feat_ids': np.array([[3, 5, 7, 9]], 'int64')}
    ids = np.array([3, 5, 7, 9])

    def delta(g):
        return {'fm_embed': (ids, np.full((4, DIM), 0.01 * g, np.float32)),
                'fm_first_w': (ids, np.full((4, 1), -0.05 * g,
                                            np.float32))}

    gens = 40
    with _engine('port', d) as eng:
        stop, seen, errs = threading.Event(), [], []

        def traffic():
            try:
                while not stop.is_set():
                    seen.append(eng.predict(probe)[0].tobytes())
            except Exception as e:      # pragma: no cover
                errs.append(e)

        th = threading.Thread(target=traffic)
        th.start()
        try:
            for g in range(1, gens):
                eng.push_rows(delta(g))
        finally:
            stop.set()
            th.join(30)
        assert not errs and seen
        answers = {eng.predict(probe)[0].tobytes()}
        for g in range(0, gens):
            if g == 0:
                # generation 0 is the startup state of these rows
                with _engine('port', d) as fresh:
                    answers.add(fresh.predict(probe)[0].tobytes())
                continue
            eng.push_rows(delta(g))
            answers.add(eng.predict(probe)[0].tobytes())
        assert len(answers) > gens // 2
        torn = [s for s in seen if s not in answers]
        assert not torn, '%d of %d answers torn' % (len(torn), len(seen))
        assert eng.stats['delta_pushes'] == 2 * gens - 2


class _Flaky(object):
    feed_names = ['x']
    fetch_names = ['y', 'agg']

    def __init__(self, fails=0, delay=0.0):
        self.fails = fails
        self.delay = delay
        self.calls = 0

    def run(self, feed):
        self.calls += 1
        if self.delay:
            time.sleep(self.delay)
        if self.fails:
            self.fails -= 1
            raise IOError('transient')
        x = feed['x']
        return [x * 2.0, np.full((x.shape[0],), x.sum(), np.float32)]


def _engine_surface(pkg):
    eng_mod = PKG[pkg]['engine']
    out = []
    for kw in (dict(per_row_outputs=[2]), dict(per_row_outputs=[-1])):
        try:
            eng_mod.ServingEngine(_Flaky(), eng_mod.ServingConfig(
                max_batch_size=4, buckets=[4]), **kw)
        except ValueError as e:
            out.append(str(e))
    cfg = eng_mod.ServingConfig(max_batch_size=4, buckets=[4],
                                max_retries=2, retry_base_delay_ms=1.0)
    model = _Flaky(fails=2)
    with eng_mod.ServingEngine(model, cfg, per_row_outputs=[0]) as eng:
        y, agg = eng.predict({'x': np.ones((2, 3), np.float32)}, timeout=30)
        out.append((y.tolist(), agg.tolist(), model.calls))
        win = eng.stats_window()
        out.append(sorted(win.items()))
        out.append(sorted(eng.stats_window().items()))
    slow = _Flaky(delay=0.3)
    with eng_mod.ServingEngine(slow, eng_mod.ServingConfig(
            max_batch_size=4, buckets=[4], max_queue_delay_ms=0.0)) as eng:
        busy = eng.submit({'x': np.ones((1, 3), np.float32)})
        time.sleep(0.05)
        queued = eng.submit({'x': np.ones((1, 3), np.float32)})
        out.append(eng.cancel(queued))
        with pytest.raises(eng_mod.DeadlineExceeded) as e:
            eng.predict({'x': np.ones((1, 3), np.float32)}, timeout=0.05)
        out.append(str(e.value).split(';')[0])
        busy.result(10)
        out.append(queued.cancelled())
        eng.request_shutdown()
        with pytest.raises(eng_mod.ServerClosed):
            eng.submit({'x': np.ones((1, 3), np.float32)})
    out.append(sorted(eng.stats))
    return out


def test_engine_surface_is_the_jax_surface():
    assert _engine_surface('port') == _engine_surface('jax')


# ---------------------------------------------------------------------------
# Router
# ---------------------------------------------------------------------------

class _Scripted(object):
    """A replica with a scripted admission window and queue: submit
    records the request (and refuses it with `refuse`), stats_window
    returns `window`."""

    def __init__(self, pkg, name, window=None, refuse=None):
        self.eng = PKG[pkg]['engine']
        self.name = name
        self.window = dict(window or {})
        self.refuse = refuse
        self.got = []
        self.closed = False

    def submit(self, feed, **kw):
        if self.refuse == 'overloaded':
            raise self.eng.ServerOverloaded('full')
        if self.refuse == 'closed' or self.closed:
            raise self.eng.ServerClosed('down')
        self.got.append(int(feed['x']))
        fut = concurrent.futures.Future()
        fut.set_result([self.name])
        return fut

    def stats_window(self):
        return dict(self.window)

    def shutdown(self, drain=True, timeout=None):
        self.closed = True
        return True


def _routing(pkg):
    rmod = PKG[pkg]['router']
    out = []
    reps = [_Scripted(pkg, 'a', {'queue_depth': 3}),
            _Scripted(pkg, 'b', {'queue_high_water': 1}),
            _Scripted(pkg, 'c', {'shed': 1})]
    r = rmod.Router(window_s=1e9).add_model('m', reps, quota=11)
    for i in range(8):
        out.append(r.predict('m', {'x': i})[0])
    try:
        r.submit('m', {'x': 99})
    except rmod.ModelOverloaded as e:
        out.append(('quota', e.model_id, str(e)))
    try:
        r.submit('ghost', {'x': 1})
    except rmod.UnknownModel as e:
        out.append(('unknown', str(e)))
    r2 = rmod.Router().add_model('n', [
        _Scripted(pkg, 'x', refuse='overloaded'),
        _Scripted(pkg, 'y', refuse='closed')])
    try:
        r2.submit('n', {'x': 1})
    except rmod.ModelOverloaded as e:
        out.append(('all refused', str(e)))
    r3 = rmod.Router().add_model('k', [_Scripted(pkg, 'z', refuse='closed')])
    try:
        r3.submit('k', {'x': 1})
    except PKG[pkg]['engine'].ServerClosed as e:
        out.append(('closed', str(e)))
    extra = _Scripted(pkg, 'd')
    rid = r2.add_replica('n', extra)
    out.append(r2.predict('n', {'x': 5})[0])
    out.append(r2.remove_replica('n', rid, drain=False) is extra)
    out.append(r2.remove_replica('n', rid) is None)
    out.append(sorted(r.models().items()))
    out.append([rep.got for rep in reps])
    try:
        rmod.Router().add_model('e', [])
    except ValueError as e:
        out.append(str(e))
    try:
        r.add_model('m', reps)
    except ValueError as e:
        out.append(str(e))
    out.append(r.shutdown())
    out.append([rep.closed for rep in reps])
    return out


def test_router_dispatch_and_quotas_are_the_jax_routers():
    got, want = _routing('port'), _routing('jax')
    assert got == want
    # the least loaded first, the routed counts spreading the rest
    assert got[:8] == ['b', 'b', 'a', 'b', 'a', 'b', 'c', 'a']
    assert got[8][0] == 'quota'


def test_router_push_deltas_reaches_every_replica(tmp_path):
    d = _serve_dir('port', tmp_path)
    e1, e2 = _engine('port', d), _engine('port', d)
    r = trouter.Router().add_model('m', [e1, e2])
    try:
        vals = np.full((2, NET_DIM), 3.0, np.float32)
        assert r.push_deltas('m', {'emb_w': (np.array([4, 5]), vals)}) == 2
        s1 = e1.predict(_probe([4, 5, 4]))[0]
        s2 = e2.predict(_probe([4, 5, 4]))[0]
        np.testing.assert_array_equal(s1, s2)
        np.testing.assert_array_equal(
            e1._model._scope.vars['emb_w'].numpy()[[4, 5]], vals)
        with pytest.raises(trouter.UnknownModel):
            r.push_deltas('ghost', {})
        with pytest.raises(ValueError, match='out of range'):
            r.push_deltas('m', {'emb_w': (np.array([99]), vals[:1])})
        e2.shutdown()
        assert r.push_deltas('m', {'emb_w': (np.array([4]), vals[:1])}) == 1
        assert r.stats()['m']['version'] == 1
    finally:
        assert r.shutdown()
    with pytest.raises(tengine.ServerClosed, match='every replica'):
        r.push_deltas('m', {'emb_w': (np.array([1]), vals[:1])})


def test_push_deltas_racing_a_swap_lands_on_the_new_generation(tmp_path):
    d = _serve_dir('port', tmp_path)
    eng0 = _engine('port', d)
    r = trouter.Router().add_model('m', [eng0])
    built = []

    def slow_builder(path):
        time.sleep(0.4)                 # hold the swap open
        e = _engine('port', path)
        built.append(e)
        return e

    try:
        swap_done = []
        th = threading.Thread(target=lambda: swap_done.append(
            r.swap('m', d, warmup_feed=_probe([0, 0, 0]),
                   builder=slow_builder)))
        th.start()
        time.sleep(0.05)
        vals = np.full((1, NET_DIM), 9.0, np.float32)
        n = r.push_deltas('m', {'emb_w': (np.array([2]), vals)})
        th.join(30)
        assert swap_done == [2] and n == 1
        assert built and built[0].stats['delta_pushes'] == 1
        assert eng0.stats['delta_pushes'] == 0
        hot = r.predict('m', _probe([2, 2, 2]))[0]
        cold = r.predict('m', _probe([0, 0, 0]))[0]
        assert not np.allclose(hot, cold)
        assert r.models()['m']['path'] == d
    finally:
        r.shutdown()
    assert eng0._thread.is_alive() is False


def test_router_parts_not_ported_raise():
    with pytest.raises(NotImplementedError, match='Analysis and tooling'):
        trouter.estimate_state_bytes('/nowhere')
    assert tserving.Router is trouter.Router
    assert tserving.DeltaUnsupported is tengine.DeltaUnsupported


# ---------------------------------------------------------------------------
# DeltaPublisher
# ---------------------------------------------------------------------------

class _Sink(object):
    """push_rows sink with a programmable failure."""

    def __init__(self):
        self.pushed = []
        self.fail = None

    def push_rows(self, deltas):
        if self.fail is not None:
            raise self.fail
        self.pushed.append({k: (np.array(v[0]), np.array(v[1]))
                            for k, v in deltas.items()})
        return sum(len(v[0]) for v in deltas.values())


def _publisher_run(pkg, table):
    st = PKG[pkg]['streaming']
    sink = _Sink()
    pub = st.DeltaPublisher(sink, interval_steps=2)
    out = []
    pub.collect({'emb_w': np.array([1, 3])})
    out.append(pub.due())
    pub.collect({'emb_w': np.array([3, 5]), 'other': np.array([], 'int64')})
    out.append((pub.due(), pub.pending_rows()))
    sink.fail = IOError('replica hiccup')
    with pytest.raises(IOError):
        pub.publish(lambda n: table)
    out.append((pub.failed_pushes, pub.pending_rows()))
    sink.fail = None
    out.append(pub.maybe_publish(lambda n: table))
    out.append(pub.maybe_publish(lambda n: table))
    q = st.DeltaPublisher(sink, interval_steps=1, quant='int8',
                          name_map={'emb_w': 'served_w'})
    q.collect({'emb_w': np.array([0, 2, 4])})
    out.append(q.publish(lambda n: table))
    stats = pub.stats()
    out.append(sorted(k for k in stats))
    out.append((stats['pushes'], stats['rows_pushed'], q.last_push_bytes,
                pub.last_push_bytes))
    with pytest.raises(ValueError, match='quant'):
        st.DeltaPublisher(sink, quant='int4')
    return out, sink.pushed


def test_publisher_cadence_retention_and_deltas_are_the_jax_publishers():
    table = np.arange(CAP * NET_DIM, dtype=np.float32).reshape(CAP, NET_DIM)
    got, got_pushed = _publisher_run('port', torch.from_numpy(table))
    want, want_pushed = _publisher_run('jax', table)
    assert got == want
    assert len(got_pushed) == len(want_pushed) == 2
    for g, w in zip(got_pushed, want_pushed):
        assert sorted(g) == sorted(w)
        for k in g:
            np.testing.assert_array_equal(g[k][0], w[k][0])
            np.testing.assert_array_equal(g[k][1], w[k][1])
    np.testing.assert_array_equal(got_pushed[0]['emb_w'][1],
                                  table[[1, 3, 5]])


def test_publisher_gathers_only_the_touched_rows_and_has_no_heartbeat():
    calls = []
    t = torch.arange(40, dtype=torch.float32).reshape(10, 4)

    def read(name):
        calls.append(name)
        return t

    sink = _Sink()
    pub = tstreaming.DeltaPublisher(sink)
    pub.collect({'w': np.array([7, 2, 7])})
    assert pub.publish(read) == 2
    np.testing.assert_array_equal(sink.pushed[0]['w'][0], [2, 7])
    np.testing.assert_array_equal(sink.pushed[0]['w'][1], t.numpy()[[2, 7]])
    assert calls == ['w']
    with pytest.raises(NotImplementedError, match='Parallel'):
        tstreaming.DeltaPublisher(sink, heartbeat=object())


# ---------------------------------------------------------------------------
# Trainer.train_stream
# ---------------------------------------------------------------------------

def _deepfm_train_func(pkg):
    p = PKG[pkg]
    fluid = p['fluid']

    def train_func():
        feat = fluid.layers.data(name='feat_ids', shape=[FIELDS],
                                 dtype='int64')
        label = fluid.layers.data(name='label', shape=[1], dtype='int64')
        cost, _, _ = p['deepfm'].deepfm(feat, label, is_sparse=True,
                                        **SMALL)
        return [cost]
    return train_func


def _deepfm_trainer(pkg, **kw):
    fluid = PKG[pkg]['fluid']
    return fluid.Trainer(_deepfm_train_func(pkg),
                         lambda: fluid.optimizer.Adam(learning_rate=1e-2),
                         place=fluid.CPUPlace(), **kw)


def _ctr_reader(n, seed=0, batch=8, step=3, lo=0):
    """n batches of the drifting stream with 0/1 labels; `lo` raw ids
    above 0."""
    def reader():
        rng = np.random.RandomState(seed + 1000)
        for ids in _drift_batches(n, batch=batch, seed=seed, step=step):
            ids = ids + lo
            lab = rng.randint(0, 2, size=(batch, 1)).astype('int64')
            yield [(ids[i], lab[i]) for i in range(batch)]
    return reader


def _state(trainer):
    return {v.name: _np(trainer.scope._chain_get(v.name))
            for v in trainer.train_program.list_vars()
            if v.persistable and trainer.scope._chain_get(v.name) is not None}


def _carry(src, dst):
    dst.scope.load_numpy(_state(src), tfluid.CPUPlace())


def _losses_into(sink):
    def handler(ev):
        if getattr(ev, 'metrics', None):
            sink.append(float(np.asarray(ev.metrics[0]).reshape(-1)[0]))
    return handler


def _stream(pkg, trainer, n, publisher_sink=None, **reader_kw):
    st = PKG[pkg]['streaming']
    vt = st.VocabTable(VOCAB, table='fm_embed', admit_count=2)
    pub = (st.DeltaPublisher(publisher_sink, interval_steps=2)
           if publisher_sink is not None else None)
    losses = []
    ran = trainer.train_stream(_ctr_reader(n, **reader_kw),
                               event_handler=_losses_into(losses),
                               vocabs={'feat_ids': vt}, publisher=pub)
    if pub is not None:
        pub.publish(lambda name: trainer.scope._chain_get(name))
    return ran, losses, vt, pub


@pytest.mark.parametrize('double_buffer', [False, True])
def test_train_stream_on_a_drifting_stream_matches_jax(double_buffer):
    jt = _deepfm_trainer('jax')
    tt = _deepfm_trainer('port', double_buffer=double_buffer)
    _carry(jt, tt)
    jsink, tsink = _Sink(), _Sink()
    misses = tt.exe.cache_stats['misses']     # the startup program's
    jn, jl, jvt, jpub = _stream('jax', jt, 14, jsink)
    tn, tl, tvt, tpub = _stream('port', tt, 14, tsink)
    assert tn == jn == 14
    np.testing.assert_allclose(tl, jl, rtol=TOL, atol=TOL)
    assert tvt.state_dict() == jvt.state_dict()
    assert tvt.rows_evicted > 0 and tvt.rows_admitted > 0
    js, ts = _state(jt), _state(tt)
    assert sorted(ts) == sorted(js)
    for n in js:
        np.testing.assert_allclose(ts[n], js[n], rtol=TOL, atol=TOL,
                                   err_msg=n)
    assert len(tsink.pushed) == len(jsink.pushed) == tpub.pushes
    for g, w in zip(tsink.pushed, jsink.pushed):
        assert sorted(g) == sorted(w) == ['fm_embed', 'fm_first_w']
        for k in g:
            np.testing.assert_array_equal(g[k][0], w[k][0])
            np.testing.assert_allclose(g[k][1], w[k][1], rtol=TOL,
                                       atol=TOL)
    assert tpub.rows_pushed == jpub.rows_pushed
    # one step artifact for the whole drifting stream
    assert tt.exe.cache_stats['misses'] == misses + 1


def test_train_stream_zeroes_evicted_rows_and_their_moments():
    """At the boundary before the step that trains an evicted row's new
    owner, the row is zero in the table and both Adam moments (read from
    BeginStepEvent, after the boundary); fm_first_w's row keeps the old
    owner's value, as in the JAX train_stream, which resets only the
    vocab's table and its moments."""
    tt = _deepfm_trainer('port')
    names = ['fm_embed', 'moment1_fm_embed_0', 'moment2_fm_embed_0']
    vt = tstreaming.VocabTable(VOCAB, table='fm_embed', admit_count=1)
    drained, checked = [], []
    drain = vt.drain_resets

    def record():
        rows = drain()
        drained.extend(rows)
        before['first'] = tt.scope.vars['fm_first_w'].clone()
        return rows

    vt.drain_resets = record
    before = {}

    def handler(ev):
        if isinstance(ev, tfluid.BeginStepEvent) and drained:
            for r in drained:
                for n in names:
                    assert not tt.scope.vars[n][r].any(), (n, r)
                assert torch.equal(tt.scope.vars['fm_first_w'][r],
                                   before['first'][r])
                checked.append(r)
            del drained[:]

    tt.train_stream(_ctr_reader(10, step=7), event_handler=handler,
                    vocabs={'feat_ids': vt})
    assert vt.rows_evicted > 0 and len(checked) == vt.rows_evicted
    assert tt.scope.vars['fm_embed'][checked].any()   # retrained after


def test_identity_vocab_is_bitwise_the_plain_loop():
    """An identity map (preload(range(vocab)), cold_row=None): train_stream
    over 8 batches is bitwise Trainer.train over the same batches."""
    def reader():
        rng = np.random.RandomState(4)
        for _ in range(8):
            ids = rng.randint(0, VOCAB, size=(8, FIELDS)).astype('int64')
            lab = rng.randint(0, 2, size=(8, 1)).astype('int64')
            yield [(ids[i], lab[i]) for i in range(8)]

    a, b, c = (_deepfm_trainer('port') for _ in range(3))
    _carry(a, b)
    _carry(a, c)
    la, lb, lc = [], [], []
    a.train(1, _losses_into(la), reader=reader)
    vt = tstreaming.VocabTable(VOCAB, table='fm_embed', admit_count=1,
                               cold_row=None)
    vt.preload(range(VOCAB))
    assert b.train_stream(reader, event_handler=_losses_into(lb),
                          vocabs={'feat_ids': vt}) == 8
    # no vocab at all: the plain loop over a stream
    assert c.train_stream(reader, event_handler=_losses_into(lc)) == 8
    assert la == lb == lc and len(la) == 8
    sa, sb, sc = _state(a), _state(b), _state(c)
    for n in sa:
        np.testing.assert_array_equal(sa[n], sb[n], err_msg=n)
        np.testing.assert_array_equal(sa[n], sc[n], err_msg=n)
    assert vt.rows_evicted == 0 and vt.cold_hits == 0


@pytest.mark.parametrize('writer,reader', [('jax', 'port'), ('port', 'jax')])
def test_a_stream_serial_resumes_in_the_other_package(writer, reader,
                                                      tmp_path):
    ck = str(tmp_path / 'ck')
    cfg = PKG[writer]['fluid'].CheckpointConfig(checkpoint_dir=ck,
                                                step_interval=1)
    w = _deepfm_trainer(writer, checkpoint_config=cfg)
    vt = PKG[writer]['streaming'].VocabTable(VOCAB, table='fm_embed',
                                             admit_count=2)
    # the stream ends at its last checkpointed step: the newest serial's
    # vocab IS the final map
    assert w.train_stream(_ctr_reader(6, lo=100), vocabs={'feat_ids': vt},
                          max_steps=6) == 6
    saved = _state(w)
    r = _deepfm_trainer(reader, checkpoint_config=PKG[reader][
        'fluid'].CheckpointConfig(checkpoint_dir=ck, step_interval=1))
    assert r.checkpoint_cfg.load_serial and r.checkpoint_cfg.step_id == 5
    vt2 = PKG[reader]['streaming'].VocabTable(VOCAB, table='fm_embed',
                                              admit_count=2)
    r.train_stream(_ctr_reader(0), vocabs={'feat_ids': vt2})
    assert vt2.state_dict() == vt.state_dict()
    got = _state(r)
    for n in saved:
        np.testing.assert_array_equal(got[n], saved[n], err_msg=n)
    # one-shot restore: the next call continues the live vocab
    r.train_stream(_ctr_reader(3, seed=7, lo=500), vocabs={'feat_ids': vt2},
                   max_steps=3)
    drifted = vt2.state_dict()
    r.train_stream(_ctr_reader(0), vocabs={'feat_ids': vt2})
    assert vt2.state_dict() == drifted != vt.state_dict()


def test_wallclock_cadence_checkpoints(tmp_path):
    ck = str(tmp_path / 'ck')
    t = _deepfm_trainer('port', checkpoint_config=tfluid.CheckpointConfig(
        checkpoint_dir=ck, step_interval=10 ** 6, wallclock_interval_s=0.0))
    t.train_stream(_ctr_reader(3), max_steps=3)
    serials = tfluid.io.list_checkpoint_serials(ck)
    assert len(serials) == 3          # one a step, never cleaned
    t2 = _deepfm_trainer('port', checkpoint_config=tfluid.CheckpointConfig(
        checkpoint_dir=str(tmp_path / 'ck2'), step_interval=2))
    t2.train_stream(_ctr_reader(5))
    assert tfluid.io.list_checkpoint_serials(str(tmp_path / 'ck2')) == [1, 2]


def test_preemption_flushes_the_vocab_and_resumes_it(tmp_path):
    ck = str(tmp_path / 'ck')
    cfg = tfluid.CheckpointConfig(checkpoint_dir=ck, step_interval=10 ** 6)
    t = _deepfm_trainer('port', checkpoint_config=cfg)
    vt = tstreaming.VocabTable(VOCAB, table='fm_embed', admit_count=2)

    def handler(ev):
        if isinstance(ev, tfluid.EndStepEvent) and ev.step == 2:
            t.request_preemption()

    with pytest.warns(RuntimeWarning, match='preemption'):
        n = t.train_stream(_ctr_reader(50), event_handler=handler,
                           vocabs={'feat_ids': vt})
    assert t.preempted and n == 3
    meta = tfluid.io.load_checkpoint(
        tfluid.Executor(tfluid.CPUPlace()), ck,
        main_program=t.train_program, scope=tfluid.Scope())
    args = meta['trainer_args']
    assert args['preempted'] and args['step_id'] == 2
    assert args['streaming_vocab'] == {'feat_ids': vt.state_dict()}
    saved = _state(t)
    t2 = _deepfm_trainer('port', checkpoint_config=cfg)
    vt2 = tstreaming.VocabTable(VOCAB, table='fm_embed', admit_count=2)
    t2.train_stream(_ctr_reader(0), vocabs={'feat_ids': vt2})
    assert vt2.state_dict() == vt.state_dict()
    got = _state(t2)
    for name in saved:
        np.testing.assert_array_equal(got[name], saved[name])


@pytest.mark.parametrize('kw', [dict(bundle_steps=4), dict(sync='async')])
def test_refused_modes_raise_the_jax_message(kw):
    msgs = []
    for pkg in ('jax', 'port'):
        with pytest.raises(ValueError, match='train_stream') as e:
            _deepfm_trainer(pkg, **kw).train_stream(_ctr_reader(1))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_a_dense_table_warns():
    fluid = tfluid

    def train_func():
        ids = fluid.layers.data(name='ids', shape=[NET_FIELDS, 1],
                                dtype='int64')
        label = fluid.layers.data(name='label', shape=[1], dtype='float32')
        emb = fluid.layers.embedding(ids, size=[CAP, NET_DIM],
                                     param_attr=fluid.ParamAttr(name='emb_w'))
        pred = fluid.layers.fc(input=emb, size=1, num_flatten_dims=2)
        score = fluid.layers.reduce_sum(pred, dim=1)
        return [fluid.layers.mean(fluid.layers.square(score - label))]

    t = fluid.Trainer(train_func, lambda: fluid.optimizer.SGD(0.1),
                      place=fluid.CPUPlace())

    def reader():
        rng = np.random.RandomState(0)
        for _ in range(3):
            ids = rng.randint(0, 50, size=(2, NET_FIELDS, 1)).astype('int64')
            yield [(ids[i], np.zeros(1, 'float32')) for i in range(2)]

    vt = tstreaming.VocabTable(CAP, table='emb_w', admit_count=1)
    with pytest.warns(RuntimeWarning, match='NOT on the sparse update'):
        t.train_stream(reader, vocabs={'ids': vt},
                       publisher=tstreaming.DeltaPublisher(_Sink()))


def test_failed_pushes_warn_and_are_retried():
    t = _deepfm_trainer('port')
    sink = _Sink()
    sink.fail = IOError('replica down')
    pub = tstreaming.DeltaPublisher(sink, interval_steps=1)
    vt = tstreaming.VocabTable(VOCAB, table='fm_embed', admit_count=1)
    with pytest.warns(RuntimeWarning, match='delta push failed'):
        t.train_stream(_ctr_reader(3), vocabs={'feat_ids': vt},
                       publisher=pub)
    assert pub.failed_pushes == 3 and pub.pushes == 0
    pending = pub.pending_rows()
    sink.fail = None
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        t.train_stream(_ctr_reader(1, seed=3), vocabs={'feat_ids': vt},
                       publisher=pub)
    assert not [w for w in caught if 'delta push' in str(w.message)]
    assert pub.pushes == 1
    assert pub.rows_pushed >= sum(pending.values())


def test_the_stream_freshens_two_router_replicas(tmp_path):
    """The end-to-end loop at small size: a DeepFM scorer saved from the
    startup state behind two ServingEngines in a Router; train_stream with
    a VocabTable and a DeltaPublisher(interval_steps=2) through
    Router.push_deltas; after a final publish each replica's answer for
    resident ids equals a Predictor of the same scorer given the trainer's
    FM tables (the dense layers are not pushed: both keep the startup
    weights)."""
    fluid, held = tfluid, {}

    def train_func():
        feat = fluid.layers.data(name='feat_ids', shape=[FIELDS],
                                 dtype='int64')
        label = fluid.layers.data(name='label', shape=[1], dtype='int64')
        cost, held['prob'], _ = tdeepfm.deepfm(feat, label, is_sparse=True,
                                               **SMALL)
        return [cost]

    t = fluid.Trainer(train_func,
                      lambda: fluid.optimizer.Adam(learning_rate=1e-2),
                      place=fluid.CPUPlace())
    d = os.path.join(str(tmp_path), 'scorer')
    with fluid.scope_guard(t.scope):
        fluid.io.save_inference_model(d, ['feat_ids'], [held['prob']],
                                      t.exe, main_program=t.train_program)
    engines = [_engine('port', d, buckets=(1, 2, 4)) for _ in range(2)]
    router = trouter.Router().add_model('ctr', engines)
    vt = tstreaming.VocabTable(VOCAB, table='fm_embed', admit_count=2)
    pub = tstreaming.DeltaPublisher(router, 'ctr', interval_steps=2)
    try:
        t.train_stream(_ctr_reader(9), vocabs={'feat_ids': vt},
                       publisher=pub)
        pub.publish(lambda n: t.scope._chain_get(n))
        assert pub.pushes >= 4 and pub.last_lag_s is not None
        assert all(e.stats['delta_pushes'] == pub.pushes for e in engines)
        rows = vt.lookup(np.array(vt.resident_ids()[-FIELDS:]))
        feed = {'feat_ids': rows.reshape(1, FIELDS)}
        served = [e.predict(feed)[0] for e in engines]
        ref = TPredictor(d, place=tfluid.CPUPlace())
        trained = _state(t)
        ref._scope.load_numpy({n: trained[n] for n in ('fm_embed',
                                                       'fm_first_w')},
                              tfluid.CPUPlace())
        want = ref.run(feed)[0]
        for s in served:
            np.testing.assert_allclose(s, want, rtol=1e-6, atol=1e-6)
        for e in engines:
            np.testing.assert_array_equal(
                e._model._scope.vars['fm_embed'].numpy()[rows.reshape(-1)],
                _state(t)['fm_embed'][rows.reshape(-1)])
    finally:
        assert router.shutdown()
