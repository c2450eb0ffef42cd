"""The port's LoD plumbing against the JAX package's, on the CPU:

  * LoDTensor: to_seq_value (with and without pad_to, 1 and 2 levels) and
    from_seq_value (the capacity-form branch too) give the JAX class's
    arrays and lengths; create_lod_tensor reads nested lists as the JAX
    one does, and refuses the same mismatches;
  * the DataFeeder's sequence slots: power-of-two buckets of the time axis
    (at least 8), lengths and a 2-level slot's outer lengths, bitwise the
    JAX feeder's;
  * the Executor's sequence feeds (a LoDTensor, a SeqValue, a dense array
    for a lod var) and fetches (a sequence as its flat valid rows, or a
    LoDTensor with return_numpy=False) against the JAX Executor's on the
    same program and weights;
  * the step cache: two time buckets are two entries, two batches of one
    bucket one entry; run_bundle over sequence feeds; state_dict skipping a
    LoD persistable; save_vars of a sequence value.
"""
import warnings

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (conftest pins it to the CPU)

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import framework as jframework
from paddle_tpu.fluid import unique_name as junique
from paddle_tpu.fluid import lod_tensor as jlod
from paddle_tpu.fluid import lowering as jlow
from paddle_tpu.fluid.executor import Scope as JScope

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import framework as tframework
from paddle_tpu_torch.fluid import unique_name as tunique
from paddle_tpu_torch.fluid import lod_tensor as tlod
from paddle_tpu_torch.fluid import lowering as tlow

TOL = 1e-6


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _same_seq(t, j):
    """A port SeqValue bitwise the JAX one (lengths by value)."""
    assert isinstance(t, tlow.SeqValue) and isinstance(j, jlow.SeqValue)
    np.testing.assert_array_equal(_np(t.data), _np(j.data))
    # ids are int32 in the JAX package (x64 off), int64 in the port
    want = _np(j.data).dtype
    assert _np(t.data).dtype == (np.int64 if want == np.int32 else want)
    np.testing.assert_array_equal(_np(t.lengths), _np(j.lengths))
    assert t.lengths.dtype == torch.int64
    jo, to = j.outer_lengths or (), t.outer_lengths or ()
    assert len(jo) == len(to)
    for a, b in zip(to, jo):
        np.testing.assert_array_equal(_np(a), _np(b))


# -- LoDTensor ---------------------------------------------------------------

ROWS = np.arange(24, dtype='float32').reshape(12, 2)
ONE_LEVEL = [[3, 0, 5, 4]]
TWO_LEVELS = [[2, 0, 2], [3, 0, 5, 4]]


@pytest.mark.parametrize('lens', [ONE_LEVEL, TWO_LEVELS])
@pytest.mark.parametrize('pad_to', [None, 8])
def test_lod_tensor_round_trip_is_the_jax_one(lens, pad_to):
    t = tlod.LoDTensor(ROWS, lens).to_seq_value(pad_to=pad_to)
    j = jlod.LoDTensor(ROWS, lens).to_seq_value(pad_to=pad_to)
    _same_seq(t, j)
    back = tlod.LoDTensor.from_seq_value(t)
    want = jlod.LoDTensor.from_seq_value(j)
    np.testing.assert_array_equal(back.data, want.data)
    np.testing.assert_array_equal(back.data, ROWS)
    assert back.recursive_sequence_lengths() == \
        want.recursive_sequence_lengths() == lens
    assert back.lod() == want.lod()
    assert back.has_valid_recursive_sequence_lengths()


def test_lod_tensor_without_lod_is_a_tensor():
    t = tlod.LoDTensor(ROWS).to_seq_value()
    assert isinstance(t, torch.Tensor)
    np.testing.assert_array_equal(t.numpy(), ROWS)


def test_from_seq_value_compacts_the_capacity_form():
    """2 sources, K = 3 slots each, 2 and 1 live: the live slots only."""
    data = np.arange(6 * 4, dtype='float32').reshape(6, 4)[:, :, None]
    lens = np.array([4, 2, 9, 1, 9, 9])
    outer = np.array([2, 1])
    t = tlod.LoDTensor.from_seq_value(tlow.SeqValue(
        torch.from_numpy(data), torch.from_numpy(lens),
        (torch.from_numpy(outer),)))
    j = jlod.LoDTensor.from_seq_value(jlow.SeqValue(
        data, lens.astype('int32'), (outer.astype('int32'),)))
    np.testing.assert_array_equal(t.data, j.data)
    assert t.recursive_sequence_lengths() == \
        j.recursive_sequence_lengths() == [[2, 1], [4, 2, 1]]


@pytest.mark.parametrize('data,lens', [
    ([[1, 2, 3], [4], [5, 6]], None),
    ([[1, 2, 3], [4], [5, 6]], [[3, 1, 2]]),
    ([[[1, 2], [3]], [[4, 5, 6]]], None),
])
def test_create_lod_tensor_is_the_jax_one(data, lens):
    t = tfluid.create_lod_tensor(data, lens, tfluid.CPUPlace())
    j = jfluid.create_lod_tensor(data, lens, jfluid.CPUPlace())
    np.testing.assert_array_equal(t.data, j.data)
    assert t.data.dtype == j.data.dtype == np.int64
    assert t.recursive_sequence_lengths() == j.recursive_sequence_lengths()


def test_create_lod_tensor_refuses_what_the_jax_one_refuses():
    for pkg in (tfluid, jfluid):
        with pytest.raises(ValueError, match='do not match'):
            pkg.create_lod_tensor([[1, 2], [3]], [[1, 2]], pkg.CPUPlace())
        with pytest.raises(ValueError, match='invalid'):
            pkg.create_lod_tensor(ROWS, [[3, 3]], pkg.CPUPlace())


def test_lod_tensor_array_coerces():
    arr = tfluid.LoDTensorArray([np.ones(2)])
    arr.append(np.zeros(3))
    arr[0] = np.arange(4)
    assert all(isinstance(a, tfluid.LoDTensor) for a in arr)
    np.testing.assert_array_equal(np.asarray(arr[0]), np.arange(4))


def test_create_random_int_lodtensor():
    t = tfluid.create_random_int_lodtensor([[2, 3]], [1], None, 0, 9)
    assert t.data.shape == (5, 1) and t.data.dtype == np.int64
    assert t.has_valid_recursive_sequence_lengths()


# -- the DataFeeder ----------------------------------------------------------

def _feeder_program(pkg):
    fluid, framework, unique_name = pkg
    main, startup = framework.Program(), framework.Program()
    with unique_name.guard(), framework.program_guard(main, startup):
        fluid.layers.data(name='words', shape=[1], dtype='int64',
                          lod_level=1)
        fluid.layers.data(name='nested', shape=[2], dtype='float32',
                          lod_level=2)
        fluid.layers.data(name='label', shape=[1], dtype='int64')
    return main


def _nested(rng, n_groups):
    return [[rng.rand(rng.randint(1, 4), 2).tolist()
             for _ in range(rng.randint(1, 3))] for _ in range(n_groups)]


@pytest.mark.parametrize('longest', [3, 8, 9, 31, 64, 100])
def test_data_feeder_buckets_are_the_jax_feeder_buckets(longest):
    rng = np.random.RandomState(longest)
    batch = []
    for i in range(5):
        n = longest if i == 2 else rng.randint(1, longest + 1)
        batch.append((rng.randint(0, 50, n).tolist(),
                      _nested(rng, 1)[0], [i % 2]))
    names = ['words', 'nested', 'label']
    tmain = _feeder_program((tfluid, tframework, tunique))
    jmain = _feeder_program((jfluid, jframework, junique))
    t = tfluid.DataFeeder(names, tfluid.CPUPlace(), program=tmain).feed(
        batch)
    j = jfluid.DataFeeder(names, jfluid.CPUPlace(), program=jmain).feed(
        batch)
    want_t = max(8, 1 << int(np.ceil(np.log2(longest))))
    assert t['words'].data.shape == (5, want_t, 1)
    for n in ('words', 'nested'):
        _same_seq(t[n], j[n])
    assert len(t['nested'].outer_lengths) == 1
    np.testing.assert_array_equal(t['label'], np.asarray(j['label']))


# -- the Executor --------------------------------------------------------------

V, E = 20, 3


def _seq_program(pkg):
    """words (lod 1) -> embedding -> tanh fc (a sequence) -> sum pool ->
    fc; startup weights from the JAX scope."""
    fluid, framework, unique_name = pkg
    main, startup = framework.Program(), framework.Program()
    with unique_name.guard(), framework.program_guard(main, startup):
        words = fluid.layers.data(name='words', shape=[1], dtype='int64',
                                  lod_level=1)
        emb = fluid.layers.embedding(words, size=[V, E])
        hid = fluid.layers.fc(emb, size=4, act='tanh')
        pooled = fluid.layers.sequence_pool(hid, 'sum')
        out = fluid.layers.fc(pooled, size=2)
    return main, startup, hid, out


def _jax_run(feeds, fetch_seq=True, return_numpy=True):
    main, startup, hid, out = _seq_program((jfluid, jframework, junique))
    scope = JScope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(startup)
        init = {n: np.array(v) for n, v in scope.vars.items()}
        res = [exe.run(main, feed=f, fetch_list=[hid, out] if fetch_seq
                       else [out], return_numpy=return_numpy)
               for f in feeds]
    return init, res


def _port(init):
    main, _, hid, out = _seq_program((tfluid, tframework, tunique))
    scope = tfluid.Scope()
    scope.load_numpy({n: a.astype('int64') if a.dtype == np.int32 else a
                      for n, a in init.items()}, tfluid.CPUPlace())
    return main, scope, hid, out, tfluid.Executor(tfluid.CPUPlace())


def _lod_feeds():
    rng = np.random.RandomState(0)
    rows = rng.randint(0, V, (9, 1)).astype('int64')
    lt = [[3, 0, 4, 2]]
    padded = np.zeros((4, 5, 1), 'int64')
    padded[:, :, 0] = rng.randint(0, V, (4, 5))
    return rows, lt, padded


@pytest.mark.parametrize('kind', ['lod_tensor', 'seq_value', 'dense'])
def test_sequence_feeds_and_fetches_are_the_jax_executor_ones(kind):
    rows, lt, padded = _lod_feeds()
    if kind == 'lod_tensor':
        jfeed = {'words': jfluid.LoDTensor(rows, lt)}
        tfeed = {'words': tfluid.LoDTensor(rows, lt)}
    elif kind == 'seq_value':
        jfeed = {'words': jlod.LoDTensor(rows, lt).to_seq_value(pad_to=8)}
        tfeed = {'words': tlod.LoDTensor(rows, lt).to_seq_value(pad_to=8)}
    else:
        jfeed = tfeed = {'words': padded}
    init, jres = _jax_run([jfeed])
    main, scope, hid, out, exe = _port(init)
    thid, tout = exe.run(main, feed=tfeed, fetch_list=[hid, out],
                         scope=scope)
    jhid, jout = jres[0]
    # a sequence fetch is its flat valid rows
    n_rows = 9 if kind != 'dense' else 20
    assert thid.shape == np.asarray(jhid).shape == (n_rows, 4)
    np.testing.assert_allclose(thid, np.asarray(jhid), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tout, np.asarray(jout), rtol=TOL, atol=TOL)


def test_return_numpy_false_gives_a_lod_tensor():
    rows, lt, _ = _lod_feeds()
    init, jres = _jax_run([{'words': jfluid.LoDTensor(rows, lt)}],
                          return_numpy=False)
    main, scope, hid, out, exe = _port(init)
    thid, tout = exe.run(main, feed={'words': tfluid.LoDTensor(rows, lt)},
                         fetch_list=[hid, out], scope=scope,
                         return_numpy=False)
    jhid = jres[0][0]
    assert isinstance(thid, tfluid.LoDTensor) and \
        isinstance(jhid, jfluid.LoDTensor)
    assert thid.recursive_sequence_lengths() == \
        jhid.recursive_sequence_lengths() == lt
    np.testing.assert_allclose(thid.data, np.asarray(jhid.data), rtol=TOL,
                               atol=TOL)
    assert isinstance(tout, torch.Tensor)
    lazy, = exe.run(main, feed={'words': tfluid.LoDTensor(rows, lt)},
                    fetch_list=[hid], scope=scope, sync='async')
    np.testing.assert_array_equal(np.asarray(lazy), np.asarray(thid.data))


def test_two_buckets_are_two_entries_and_one_bucket_one():
    """Lengths that differ within a bucket share its artifact (on the card
    its captured graph); a batch in the next bucket adds one."""
    main, startup, _, out = _seq_program((tfluid, tframework, tunique))
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    feeder = tfluid.DataFeeder(['words'], tfluid.CPUPlace(), program=main)
    rng = np.random.RandomState(1)

    def batch(longest):
        return feeder.feed([(rng.randint(0, V, n).tolist(),)
                            for n in (longest, 2, longest - 1)])

    base = exe.cache_stats      # the startup program's entry

    def grown():
        return tuple(exe.cache_stats[k] - base[k]
                     for k in ('entries', 'misses', 'hits'))

    exe.run(main, feed=batch(5), fetch_list=[out], scope=scope)
    exe.run(main, feed=batch(7), fetch_list=[out], scope=scope)
    assert grown() == (1, 1, 1)
    exe.run(main, feed=batch(12), fetch_list=[out], scope=scope)
    assert grown() == (2, 2, 1)
    sigs = sorted(a._feed_sig for a in exe._cache.values() if a._feed_sig)
    assert [s[0][2][0] for s in sigs] == [(3, 8, 1), (3, 16, 1)]


def test_lod_tensor_requests_share_a_bucket_through_predictor(tmp_path):
    """Predictor.run pads a LoDTensor feed to the feeder's bucket: requests
    whose longest sequences are 9 and 15 share one cache entry (on the card
    one captured graph), one of 17 adds a second, and each answer is the
    JAX Predictor's."""
    from paddle_tpu.inference import Predictor as JPredictor
    from paddle_tpu_torch.inference import Predictor
    init, _ = _jax_run([])
    main, scope, _, out, exe = _port(init)
    test = main.clone(for_test=True)
    tfluid.io.save_inference_model(str(tmp_path / 't'), ['words'], [out],
                                   exe, main_program=test, scope=scope)
    jmain, jstartup, _, jout = _seq_program((jfluid, jframework, junique))
    jscope = JScope()
    with jfluid.scope_guard(jscope):
        jscope.vars.update(init)
        jexe = jfluid.Executor(jfluid.CPUPlace())
        jfluid.io.save_inference_model(
            str(tmp_path / 'j'), ['words'], [jout], jexe,
            main_program=jmain.clone(for_test=True))
    pred = Predictor(str(tmp_path / 't'), place=tfluid.CPUPlace())
    jpred = JPredictor(str(tmp_path / 'j'))
    rng = np.random.RandomState(3)
    base = pred._exe.cache_stats['entries']
    grown = []
    for longest in (9, 15, 17):
        lt = [[longest, 2, 0]]
        rows = rng.randint(0, V, (sum(lt[0]), 1)).astype('int64')
        got, = pred.run({'words': tfluid.LoDTensor(rows, lt)})
        want, = jpred.run({'words': jfluid.LoDTensor(rows, lt)})
        np.testing.assert_allclose(got, np.asarray(want), rtol=TOL,
                                   atol=TOL)
        grown.append(pred._exe.cache_stats['entries'] - base)
    assert grown == [1, 1, 2]


def test_run_bundle_over_sequence_feeds():
    main, startup, hid, out = _seq_program((tfluid, tframework, tunique))
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    feeder = tfluid.DataFeeder(['words'], tfluid.CPUPlace(), program=main)
    rng = np.random.RandomState(2)
    feeds = [feeder.feed([(rng.randint(0, V, n).tolist(),)
                          for n in (3, 5, 1)]) for _ in range(3)]
    stacked, = exe.run_bundle(main, feeds=feeds, fetch_list=[out],
                              scope=scope)
    single = [exe.run(main, feed=f, fetch_list=[out], scope=scope)[0]
              for f in feeds]
    np.testing.assert_array_equal(stacked, np.stack(single))
    # a sequence fetch is a list of K values, as the JAX run_bundle gives
    # it (paddle_tpu/fluid/executor.py:1675-1677); a dense one is stacked
    hids, outs = exe.run_bundle(main, feeds=feeds, fetch_list=[hid, out],
                                scope=scope)
    assert isinstance(hids, list) and len(hids) == 3
    for h, f in zip(hids, feeds):
        assert h.shape == (9, 4)
        np.testing.assert_array_equal(
            h, exe.run(main, feed=f, fetch_list=[hid], scope=scope)[0])
    assert outs.shape == (3, 3, 2)
    np.testing.assert_array_equal(outs, stacked)
    lts, _ = exe.run_bundle(main, feeds=feeds, fetch_list=[hid, out],
                            scope=scope, return_numpy=False)
    assert [lt.recursive_sequence_lengths() for lt in lts] == [[[3, 5, 1]]] * 3
    for lt, h in zip(lts, hids):
        np.testing.assert_array_equal(np.asarray(lt.data), h)
    # the same bundle in the JAX package, from the port's startup weights
    jmain, _, jhid, jout = _seq_program((jfluid, jframework, junique))
    jscope = JScope()
    jscope.vars.update(scope.to_numpy([n for n in scope.vars]))
    jfeeder = jfluid.DataFeeder(['words'], jfluid.CPUPlace(), program=jmain)
    rng = np.random.RandomState(2)
    jfeeds = [jfeeder.feed([(rng.randint(0, V, n).tolist(),)
                            for n in (3, 5, 1)]) for _ in range(3)]
    with jfluid.scope_guard(jscope):
        jh, jo = jfluid.Executor(jfluid.CPUPlace()).run_bundle(
            jmain, feeds=jfeeds, fetch_list=[jhid, jout])
    assert len(jh) == 3
    for a, b in zip(hids, jh):
        np.testing.assert_allclose(a, np.asarray(b), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(outs, np.asarray(jo), rtol=TOL, atol=TOL)
    other = feeder.feed([(rng.randint(0, V, 9).tolist(),)] * 3)
    with pytest.raises(ValueError, match='signature'):
        exe.run_bundle(main, feeds=[feeds[0], other], fetch_list=[out],
                       scope=scope)


def test_state_dict_skips_and_save_vars_keeps_a_lod_persistable(tmp_path):
    main, startup, _, out = _seq_program((tfluid, tframework, tunique))
    blk = main.global_block()
    lod_var = blk.create_var(name='held_seq', shape=[-1, -1, 1],
                             dtype='int64', lod_level=1, persistable=True)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    sv = tlod.LoDTensor(np.arange(5).reshape(5, 1), [[2, 3]]).to_seq_value()
    scope.vars['held_seq'] = sv
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        state = exe.state_dict(main, scope)
    assert 'held_seq' not in state and state
    assert any('held_seq' in str(w.message) for w in caught)
    path = tfluid.io.save_vars(exe, str(tmp_path), vars=[lod_var],
                               scope=scope)
    saved = np.load(path)
    np.testing.assert_array_equal(saved['held_seq'], sv.data.numpy())
