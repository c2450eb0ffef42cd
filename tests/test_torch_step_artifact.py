"""The port's compiled-step layer (fluid/step_artifact.py and the entry
points of fluid/executor.py) on the CPU, against the JAX package: the
cases of tests/test_step_artifact.py and tests/test_bundle.py that need
no mesh, AOT or Trainer. The same programs (built under a fresh
unique_name guard in each package) and the same weights (the JAX startup
scope carried into the port) run through both packages.

Tolerances: the port's entry points against each other bitwise (one
eager body on the CPU); fetches against the JAX package 1e-6 on the
exact-arithmetic forward and on the fit_a_line-shaped regression's
losses and parameters (fp32 sums of 16 rows in another order); the
guard's gradient norm 1e-5. On the card the same entry points replay
captured CUDA graphs: tests/test_torch_cuda.py holds those.
"""
import gc
import warnings

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (conftest pins it to the CPU)

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import unique_name as junique

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import obs as tobs
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.fluid import unique_name as tunique
from paddle_tpu_torch.fluid.executor import FetchHandle
from paddle_tpu_torch.fluid.step_artifact import (StepArtifact,
                                                  stable_signature)

TOL = 1e-6
HEALTH_TOL = 1e-5
JAX = (jfluid, junique)
PORT = (tfluid, tunique)


def _forward_program(pkg):
    """fc 8 -> 1 whose arithmetic is exact in fp32 (powers of two)."""
    fluid, unique_name = pkg
    prog, start = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(prog, start):
        x = fluid.layers.data(name='x', shape=[8], dtype='float32')
        out = fluid.layers.fc(input=x, size=1, act=None,
                              param_attr=fluid.ParamAttr(name='w'),
                              bias_attr=fluid.ParamAttr(name='b'))
    return prog, out


def _exact_feed(batch=8):
    rng = np.random.RandomState(0)
    return {'x': (2.0 ** rng.randint(-2, 2, size=(batch, 8)))
            .astype('float32')}


def _exact_params():
    return {'w': (2.0 ** (-(np.arange(8) % 4))).astype('float32')
            .reshape(8, 1), 'b': np.asarray([0.125], 'float32')}


def _regression(pkg, lr=0.1, guard=False, max_skips=None):
    """fit_a_line-shaped: fc 13 -> 1, square error, mean, SGD."""
    fluid, unique_name = pkg
    prog, start = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(prog, start):
        x = fluid.layers.data(name='x', shape=[13], dtype='float32')
        y = fluid.layers.data(name='y', shape=[1], dtype='float32')
        pred = fluid.layers.fc(input=x, size=1)
        loss = fluid.layers.mean(
            fluid.layers.square_error_cost(input=pred, label=y))
        fluid.optimizer.SGD(learning_rate=lr).minimize(loss)
    if guard:
        fluid.anomaly_guard(prog, max_consecutive_skips=max_skips)
    w_names = sorted(v.name for v in prog.list_vars()
                     if v.persistable and 'fc' in v.name)
    return prog, start, loss, w_names


def _feeds(n, seed=0, batch=16):
    rng = np.random.RandomState(seed)
    return [{'x': rng.rand(batch, 13).astype('float32'),
             'y': rng.rand(batch, 1).astype('float32')} for _ in range(n)]


def _poison(feed, seed, rate):
    """NaN into a `rate` share of x's entries (FaultInjector.poison_nan)."""
    x = feed['x'].copy()
    rng = np.random.RandomState(seed)
    x[rng.rand(*x.shape) < rate] = np.nan
    return dict(feed, x=x)


def _jax_start(start):
    """The JAX startup scope's values as numpy."""
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jscope = jfluid.Scope()
    jexe.run(start, scope=jscope)
    return {n: np.asarray(v) for n, v in jscope.vars.items()}


def _port(init):
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    scope.load_numpy(init, tfluid.CPUPlace())
    return exe, scope


# ---------------------------------------------------------------------------
# one artifact, four entry points
# ---------------------------------------------------------------------------

def test_four_entry_points_share_one_artifact_and_match_bitwise():
    """run / run_bundle(K=1) / StepHandle.step / the serving dispatch: one
    cache entry, one miss, every entry point on one key, bitwise equal
    fetches,
    within 1e-6 of the JAX package's run."""
    prog, out = _forward_program(PORT)
    exe, scope = _port(_exact_params())
    feed = _exact_feed()
    keys = []

    r_run = exe.run(prog, feed=feed, fetch_list=[out], scope=scope)[0]
    keys.append(exe._last_cache_lookup['key'])
    assert exe._last_cache_lookup['outcome'] == 'miss'

    r_bundle = exe.run_bundle(prog, feeds=[feed], fetch_list=[out],
                              scope=scope)[0][0]
    keys.append(exe._last_cache_lookup['key'])
    assert exe._last_cache_lookup['outcome'] == 'hit'

    handle = exe.acquire_step(prog, feed=feed, fetch_list=[out],
                              scope=scope)
    keys.append(exe._last_cache_lookup['key'])
    r_handle = handle.step({'x': feed['x']})[0].numpy()

    class _Model(object):
        feed_names = ['x']
        fetch_names = [out.name]

        def run(self, f):
            r = exe.run(prog, feed=f, fetch_list=[out], scope=scope)
            keys.append(exe._last_cache_lookup['key'])
            return r

    eng = tserving.ServingEngine(
        _Model(), tserving.ServingConfig(max_batch_size=8, buckets=[8]))
    try:
        r_serve = eng.submit(feed).result(timeout=60)[0]
    finally:
        eng.shutdown()

    np.testing.assert_array_equal(r_run, r_bundle)
    np.testing.assert_array_equal(r_run, r_handle)
    np.testing.assert_array_equal(r_run, r_serve)
    stats = exe.cache_stats
    assert stats['entries'] == 1 and stats['misses'] == 1, stats
    assert stats['captures'] == 0 and stats['replays'] == 0, stats
    assert len(set(keys)) == 1, keys
    art = list(exe._cache.values())[0]
    assert isinstance(art, StepArtifact)
    assert art.signatures() == [('step',), ('bundle', 1)]
    assert exe.step_artifact(prog, feed=feed, fetch_list=[out],
                             scope=scope) is art

    jprog, jout = _forward_program(JAX)
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jscope = jfluid.Scope()
    jscope.vars.update(_exact_params())
    with jfluid.scope_guard(jscope):
        j_run = np.asarray(jexe.run(jprog, feed=feed, fetch_list=[jout])[0])
    np.testing.assert_allclose(r_run, j_run, rtol=TOL, atol=TOL)


def test_one_artifact_per_signature():
    """Each (feed signature, fetch set) is one entry; repeating one is a
    hit; the stable signature tells the entries apart."""
    prog, out = _forward_program(PORT)
    exe, scope = _port(_exact_params())
    for batch in (8, 4, 8, 4, 2):
        exe.run(prog, feed=_exact_feed(batch), fetch_list=[out],
                scope=scope)
    exe.run(prog, feed=_exact_feed(8), fetch_list=[], scope=scope)
    stats = exe.cache_stats
    assert stats['entries'] == 4 and stats['misses'] == 4, stats
    assert stats['hits'] == 2, stats
    sigs = {stable_signature(a) for a in exe._cache.values()}
    assert len(sigs) == 4
    exe.run(prog, feed=_exact_feed(8), fetch_list=[out], scope=scope,
            use_program_cache=False)
    assert exe.cache_stats['entries'] == 4
    exe.close()
    assert exe.cache_stats['entries'] == 0
    assert exe.cache_stats['evictions'] == 4


# ---------------------------------------------------------------------------
# run_bundle
# ---------------------------------------------------------------------------

def _train_bundled(init, feeds, K, guard=False, max_skips=None):
    prog, _, loss, w_names = _regression(PORT, guard=guard,
                                         max_skips=max_skips)
    exe, scope = _port(init)
    losses = []
    for i in range(0, len(feeds), K):
        out = exe.run_bundle(prog, feeds=feeds[i:i + K], fetch_list=[loss],
                             scope=scope)
        assert out[0].shape[0] == len(feeds[i:i + K])
        losses.extend(out[0].reshape(-1).tolist())
    return losses, scope.to_numpy(w_names), exe


def test_bundle_k1_vs_k4_and_the_unbundled_trajectory():
    """K=1 and K=4 bundles and eight run() calls reach bitwise equal
    losses and parameters; within 1e-6 of the JAX package's run_bundle."""
    feeds = _feeds(8)
    _, start, jloss, w_names = _regression(JAX)
    init = _jax_start(start)
    l1, w1, _ = _train_bundled(init, feeds, 1)
    l4, w4, _ = _train_bundled(init, feeds, 4)
    assert l1 == l4
    prog, _, loss, _ = _regression(PORT)
    exe, scope = _port(init)
    lu = [float(exe.run(prog, feed=f, fetch_list=[loss],
                        scope=scope)[0][0]) for f in feeds]
    assert lu == l1
    wu = scope.to_numpy(w_names)
    for n in w_names:
        np.testing.assert_array_equal(w1[n], w4[n])
        np.testing.assert_array_equal(w1[n], wu[n])

    jprog, _, jloss, _ = _regression(JAX)
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jscope = jfluid.Scope()
    jscope.vars.update(init)
    jl = []
    with jfluid.scope_guard(jscope):
        for i in range(0, 8, 4):
            jl.extend(np.asarray(jexe.run_bundle(
                jprog, feeds=feeds[i:i + 4],
                fetch_list=[jloss])[0]).reshape(-1).tolist())
    np.testing.assert_allclose(l4, jl, rtol=TOL, atol=TOL)
    for n in w_names:
        np.testing.assert_allclose(w4[n], np.asarray(jscope.vars[n]),
                                   rtol=TOL, atol=TOL)


def test_bundle_validation_errors():
    feeds = _feeds(4)
    prog, start, loss, _ = _regression(PORT)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    with pytest.raises(ValueError, match='no value'):
        exe.run_bundle(prog, feeds=feeds, fetch_list=[loss], scope=scope)
    exe.run(start, scope=scope)
    with pytest.raises(ValueError, match='non-empty'):
        exe.run_bundle(prog, feeds=[], fetch_list=[loss], scope=scope)
    with pytest.raises(ValueError, match='steps=3'):
        exe.run_bundle(prog, feeds=feeds, fetch_list=[loss], steps=3,
                       scope=scope)
    with pytest.raises(ValueError, match='shape'):
        exe.run_bundle(prog, feeds=[feeds[0], dict(feeds[1],
                                                   x=feeds[1]['x'][:5])],
                       fetch_list=[loss], scope=scope)
    with pytest.raises(ValueError, match='names'):
        exe.run_bundle(prog, feeds=[feeds[0], {'x': feeds[1]['x']}],
                       fetch_list=[loss], scope=scope)
    with pytest.raises(ValueError, match='sync'):
        exe.run_bundle(prog, feeds=feeds, fetch_list=[loss], sync='nope',
                       scope=scope)


def test_bundle_per_step_seed_parity():
    """Dropout masks at bundled inner step j equal unbundled run j's,
    bitwise, and differ from step to step."""
    def build():
        prog, start = tfluid.Program(), tfluid.Program()
        with tunique.guard(), tfluid.program_guard(prog, start):
            x = tfluid.layers.data(name='x', shape=[32], dtype='float32')
            out = tfluid.layers.dropout(x, dropout_prob=0.5)
        return prog, start, out

    feeds = [{'x': np.ones((4, 32), 'float32')} for _ in range(4)]
    prog, start, out = build()
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(start, scope=scope)
    masks_u = [exe.run(prog, feed=f, fetch_list=[out], scope=scope)[0]
               for f in feeds]
    prog, start, out = build()
    exe2 = tfluid.Executor(tfluid.CPUPlace())
    scope2 = tfluid.Scope()
    exe2.run(start, scope=scope2)
    masks_b = exe2.run_bundle(prog, feeds=feeds, fetch_list=[out],
                              scope=scope2)[0]
    assert masks_b.shape[0] == 4
    for j in range(4):
        np.testing.assert_array_equal(masks_u[j], masks_b[j])
    assert (masks_b == 0).sum() > 0
    assert any(not np.array_equal(masks_b[0], masks_b[j])
               for j in range(1, 4))


# ---------------------------------------------------------------------------
# the anomaly guard
# ---------------------------------------------------------------------------

def test_guard_skips_per_inner_step(tmp_path):
    feeds = _feeds(4)
    feeds[1] = _poison(feeds[1], 3, 0.5)
    _, start, _, w_names = _regression(JAX)
    tobs.enable(str(tmp_path / 'obs'))
    try:
        prog, _, loss, _ = _regression(PORT, guard=True)
        exe, scope = _port(_jax_start(start))
        exe._run_counter = 1           # as if the startup ran here
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter('always')
            exe.run_bundle(prog, feeds=feeds, fetch_list=[loss],
                           scope=scope)
        path = tobs.run_log_path()
    finally:
        tobs._reset()
    assert exe.skipped_steps == 1
    assert any('anomaly guard' in str(w.message) for w in rec)
    import json
    skips = [e for e in map(json.loads, open(path))
             if e.get('name') == 'anomaly.skip']
    # the second inner step, run 3 (the startup was run 1)
    assert len(skips) == 1 and skips[0]['fields']['run'] == 3
    assert exe._consecutive_skips == 0
    assert bool(exe.last_step_health['healthy'])


def test_guard_rolls_back_bitwise_and_escalates():
    feeds = [_poison(f, 5 + i, 1.0) for i, f in enumerate(_feeds(6))]
    _, start, _, w_names = _regression(JAX)
    init = _jax_start(start)
    prog, _, loss, _ = _regression(PORT, guard=True)
    exe, scope = _port(init)
    exe.run(prog, feed=_feeds(1, seed=9)[0], fetch_list=[loss], scope=scope)
    before = scope.to_numpy(w_names)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        exe.run_bundle(prog, feeds=feeds[:4], fetch_list=[loss],
                       scope=scope)
        exe.run(prog, feed=feeds[4], fetch_list=[loss], scope=scope)
    assert exe.skipped_steps == 5
    after = scope.to_numpy(w_names)
    for n in w_names:
        np.testing.assert_array_equal(before[n], after[n])

    prog, _, loss, _ = _regression(PORT, guard=True, max_skips=3)
    exe, scope = _port(init)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        with pytest.raises(FloatingPointError, match='consecutive'):
            exe.run_bundle(prog, feeds=feeds, fetch_list=[loss],
                           scope=scope)
    assert exe.skipped_steps == 3


@pytest.mark.parametrize('poisoned', [False, True])
def test_guard_health_vector_against_jax(poisoned):
    feed = _feeds(1, seed=4)[0]
    if poisoned:
        feed = _poison(feed, 2, 0.25)
    jprog, start, jloss, _ = _regression(JAX, guard=True)
    init = _jax_start(start)
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jscope = jfluid.Scope()
    jscope.vars.update(init)
    prog, _, loss, _ = _regression(PORT, guard=True)
    exe, scope = _port(init)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        with jfluid.scope_guard(jscope):
            jexe.run(jprog, feed=feed, fetch_list=[jloss])
        exe.run(prog, feed=feed, fetch_list=[loss], scope=scope)
    jh, th = jexe.last_step_health, exe.last_step_health
    assert sorted(jh) == sorted(th)
    for k in ('healthy', 'loss_finite', 'grads_finite'):
        assert bool(jh[k]) == bool(th[k]) == (not poisoned), k
    np.testing.assert_allclose(th['grad_norm'], np.asarray(jh['grad_norm']),
                               rtol=HEALTH_TOL, atol=HEALTH_TOL,
                               equal_nan=True)


# ---------------------------------------------------------------------------
# the async fetch window
# ---------------------------------------------------------------------------

def test_async_run_returns_lazy_handles():
    feed = _feeds(1)[0]
    _, start, _, _ = _regression(JAX)
    init = _jax_start(start)
    prog, _, loss, _ = _regression(PORT)
    exe, scope = _port(init)
    blocking = float(exe.run(prog, feed=feed, fetch_list=[loss],
                             scope=scope)[0][0])
    hist = tobs.histogram('executor.host_stall.seconds')
    n0 = hist.count
    prog, _, loss, _ = _regression(PORT)
    exe2, scope2 = _port(init)
    h, = exe2.run(prog, feed=feed, fetch_list=[loss], scope=scope2,
                  sync='async')
    assert isinstance(h, FetchHandle)
    assert h.ready
    assert float(h) == blocking
    np.testing.assert_array_equal(np.asarray(h), np.asarray(h))
    assert hist.count == n0 + 1
    d, = exe2.run(prog, feed=feed, fetch_list=[loss], scope=scope2,
                  sync='async', return_numpy=False)
    assert isinstance(d.block(), torch.Tensor)
    del h, d
    gc.collect()
    assert tobs.gauge('executor.inflight').value == 0


def test_async_handle_defers_and_reraises_errors():
    calls = []

    def boom():
        calls.append(1)
        raise RuntimeError('device exploded')

    g = tobs.gauge('executor.inflight')
    base = g.value or 0
    h = FetchHandle(np.zeros(3), boom)
    assert (g.value or 0) == base + 1
    with pytest.raises(RuntimeError, match='device exploded'):
        h.block()
    with pytest.raises(RuntimeError, match='device exploded'):
        np.asarray(h)
    assert calls == [1]
    assert (g.value or 0) == base


def test_async_unread_handle_releases_its_slot_and_float_needs_one():
    g = tobs.gauge('executor.inflight')
    base = g.value or 0
    h = FetchHandle(np.arange(4.0))
    assert (g.value or 0) == base + 1
    with pytest.raises(TypeError, match='one-element'):
        float(h)
    h2 = FetchHandle(np.arange(2.0))
    del h2
    gc.collect()
    assert (g.value or 0) == base


# ---------------------------------------------------------------------------
# the StepHandle seam
# ---------------------------------------------------------------------------

def test_step_handle_state_seam_and_invalidation():
    _, start, _, _ = _regression(JAX)
    prog, _, loss, _ = _regression(PORT)
    exe, scope = _port(_jax_start(start))
    feed = _feeds(1)[0]
    h = exe.acquire_step(prog, feed=feed, fetch_list=[loss], scope=scope)
    sd = h.state_dict()
    assert set(sd) == set(h._compiled.state_names)
    for n, v in sd.items():
        assert v is scope._chain_get(n)
    h.step(feed)
    w = [n for n in h.state if n.endswith('.w_0')][0]
    h.set_state(w, torch.zeros_like(h.state[w]))
    assert not scope._chain_get(w).any()
    h.step(feed)
    exe.run(prog, feed=feed, fetch_list=[loss], scope=scope)   # foreign
    with pytest.raises(RuntimeError, match='re-acquire_step'):
        h.step(feed)
    with pytest.raises(KeyError, match='no persistable'):
        h.set_state('nope', torch.zeros(1))


def test_step_handle_detects_foreign_scope_writes():
    """tests/test_decode.py's drill: a run() between a handle's steps
    invalidates it; a fresh handle resumes from the scope."""
    prog = tfluid.Program()
    blk = prog.global_block()
    x = blk.create_var(name='sh3_x', shape=[2, 2], dtype='float32',
                       persistable=True)
    blk.append_op(type='scale', inputs={'X': [x]}, outputs={'Out': [x]},
                  attrs={'scale': 2.0, 'bias': 0.0,
                         'bias_after_scale': True})
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    scope.vars['sh3_x'] = torch.ones((2, 2))
    handle = exe.acquire_step(prog, fetch_list=[], scope=scope)
    handle.step()
    exe.run(prog, fetch_list=[], scope=scope)
    with pytest.raises(RuntimeError, match='re-acquire_step'):
        handle.step()
    exe.acquire_step(prog, fetch_list=[], scope=scope).step()
    np.testing.assert_array_equal(scope.vars['sh3_x'].numpy(),
                                  np.full((2, 2), 8.0, np.float32))


# ---------------------------------------------------------------------------
# touched_rows and check_nan_inf against the JAX package
# ---------------------------------------------------------------------------

def _sparse_model(pkg, vocab=50):
    fluid, unique_name = pkg
    prog, start = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(prog, start):
        a = fluid.layers.data(name='a', shape=[3, 1], dtype='int64')
        b = fluid.layers.data(name='b', shape=[2, 1], dtype='int64')
        ea = fluid.layers.embedding(a, size=[vocab, 4], is_sparse=True,
                                    padding_idx=0,
                                    param_attr=fluid.ParamAttr(name='tw'))
        eb = fluid.layers.embedding(b, size=[vocab, 4], is_sparse=True,
                                    param_attr=fluid.ParamAttr(name='tw'))
        d = fluid.layers.embedding(a, size=[vocab, 4],
                                   param_attr=fluid.ParamAttr(name='dw'))
        s = fluid.layers.fc(input=ea, size=1, num_flatten_dims=2) + \
            fluid.layers.fc(input=d, size=1, num_flatten_dims=2)
        loss = fluid.layers.mean(s) + fluid.layers.mean(
            fluid.layers.fc(input=eb, size=1, num_flatten_dims=2))
        fluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
    return prog, start, loss


def test_touched_rows_equal_jax():
    rng = np.random.RandomState(7)
    feed = {'a': rng.randint(0, 6, size=(5, 3, 1)).astype('int64'),
            'b': rng.randint(0, 50, size=(5, 2, 1)).astype('int64')}
    feed['a'][0, 0, 0] = 0                    # the padding row
    jprog, start, jloss = _sparse_model(JAX)
    init = _jax_start(start)
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jscope = jfluid.Scope()
    jscope.vars.update(init)
    with jfluid.scope_guard(jscope):
        want = jexe.step_artifact(jprog, feed=feed,
                                  fetch_list=[jloss]).touched_rows(feed)
    prog, _, loss = _sparse_model(PORT)
    exe, scope = _port({n: v.astype('int64') if v.dtype == np.int32 else v
                        for n, v in init.items()})
    art = exe.step_artifact(prog, feed=feed, fetch_list=[loss], scope=scope)
    got = art.touched_rows(feed)
    assert sorted(got) == sorted(want) == ['tw']
    np.testing.assert_array_equal(got['tw'], np.asarray(want['tw']))


def _nan_program(pkg):
    """x -> fc -> sqrt (NaN where the fc output is negative) -> mean."""
    fluid, unique_name = pkg
    prog, start = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(prog, start):
        x = fluid.layers.data(name='x', shape=[4], dtype='float32')
        h = fluid.layers.fc(input=x, size=3)
        out = fluid.layers.mean(fluid.layers.sqrt(h))
    return prog, start, out


def test_check_nan_inf_names_the_op_jax_names():
    feed = {'x': -np.ones((2, 4), 'float32')}
    jprog, start, jout = _nan_program(JAX)
    init = _jax_start(start)
    init = {n: np.abs(v) for n, v in init.items()}   # fc output < 0
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jscope = jfluid.Scope()
    jscope.vars.update(init)
    from paddle_tpu.fluid import debugger as jdebugger
    with jfluid.scope_guard(jscope), jdebugger.check_nan_inf():
        with pytest.raises(FloatingPointError) as jerr:
            jexe.run(jprog, feed=feed, fetch_list=[jout])
    prog, _, out = _nan_program(PORT)
    exe, scope = _port(init)
    # unchecked, the NaN reaches the fetch; checked, the op is named
    assert np.isnan(exe.run(prog, feed=feed, fetch_list=[out],
                            scope=scope)[0]).all()
    with tfluid.debugger.check_nan_inf():
        assert tfluid.debugger.nan_inf_check_active()
        with pytest.raises(FloatingPointError) as terr:
            exe.run(prog, feed=feed, fetch_list=[out], scope=scope)
    assert not tfluid.debugger.nan_inf_check_active()
    assert str(terr.value) == str(jerr.value)
    assert "'sqrt'" in str(terr.value)


def _sparse_regression(pkg, vocab=40):
    """ids -> is_sparse embedding (Adam) -> fc -> mean((pred - y)^2): the
    sparse rule updates the table and its moments in place."""
    fluid, unique_name = pkg
    prog, start = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(prog, start):
        ids = fluid.layers.data(name='ids', shape=[3, 1], dtype='int64')
        y = fluid.layers.data(name='y', shape=[3, 1], dtype='float32')
        emb = fluid.layers.embedding(ids, size=[vocab, 4], is_sparse=True,
                                     param_attr=fluid.ParamAttr(name='sw'))
        pred = fluid.layers.fc(input=emb, size=1, num_flatten_dims=2)
        loss = fluid.layers.mean(fluid.layers.square(pred - y))
        fluid.optimizer.Adam(learning_rate=0.05).minimize(loss)
    fluid.anomaly_guard(prog)
    return prog, start, loss


def test_guard_rolls_back_the_sparse_rules_in_place_updates():
    """The sparse Adam rule updates its table and moments in place; an
    unhealthy step leaves them bitwise as they were, and the healthy
    steps' health vectors agree with the JAX package's."""
    rng = np.random.RandomState(5)
    feeds = [{'ids': rng.randint(0, 40, (6, 3, 1)).astype('int64'),
              'y': rng.randn(6, 3, 1).astype('float32')} for _ in range(3)]
    bad = dict(feeds[1], y=np.full((6, 3, 1), np.nan, 'float32'))
    jprog, start, jloss = _sparse_regression(JAX)
    init = _jax_start(start)
    prog, _, loss = _sparse_regression(PORT)
    exe, scope = _port(init)
    art = exe.step_artifact(prog, feed=feeds[0], fetch_list=[loss],
                            scope=scope)
    assert sorted(art.sparse_plan) == ['sw']
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jscope = jfluid.Scope()
    jscope.vars.update(init)
    norms = []
    for f in (feeds[0], feeds[2]):
        with jfluid.scope_guard(jscope):
            jexe.run(jprog, feed=f, fetch_list=[jloss])
        exe.run(prog, feed=f, fetch_list=[loss], scope=scope)
        norms.append((float(exe.last_step_health['grad_norm']),
                      float(np.asarray(jexe.last_step_health['grad_norm']))))
        if f is feeds[0]:
            table = scope.vars['sw']
            before = scope.to_numpy()
            with warnings.catch_warnings():
                warnings.simplefilter('ignore')
                exe.run(prog, feed=bad, fetch_list=[loss], scope=scope)
            assert exe.skipped_steps == 1
            after = scope.to_numpy()
            assert sorted(after) == sorted(before)
            for n in before:
                np.testing.assert_array_equal(after[n], before[n],
                                              err_msg=n)
            assert scope.vars['sw'] is not table    # the CPU step rebinds
    for got, want in norms:
        np.testing.assert_allclose(got, want, rtol=HEALTH_TOL,
                                   atol=HEALTH_TOL)
    np.testing.assert_allclose(scope.vars['sw'].numpy(),
                               np.asarray(jscope.vars['sw']), rtol=1e-5,
                               atol=1e-6)


def test_a_constant_op_writing_a_persistable_hands_out_fresh_copies():
    """assign_value writing a persistable (a startup initializer) is
    evaluated once and cloned on every run, so a captured step copies on
    the card instead of from the host: the values are the JAX rule's, and
    each run's tensor is its own."""
    vals = np.arange(6, dtype='float32').reshape(2, 3) / 8.0
    outs = {}
    for name, (fluid, unique_name) in (('jax', JAX), ('port', PORT)):
        prog = fluid.Program()
        blk = prog.global_block()
        w = blk.create_var(name='aw', shape=[2, 3], dtype='float32',
                           persistable=True)
        blk.append_op(type='assign_value', outputs={'Out': [w]},
                      attrs={'shape': [2, 3], 'dtype': 'float32',
                             'values': vals.reshape(-1).tolist()})
        outs[name] = prog
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jscope = jfluid.Scope()
    jexe.run(outs['jax'], scope=jscope)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(outs['port'], scope=scope)
    first = scope.vars['aw']
    exe.run(outs['port'], scope=scope)
    second = scope.vars['aw']
    assert first is not second
    with torch.no_grad():
        first.add_(1.0)
    np.testing.assert_array_equal(second.numpy(),
                                  np.asarray(jscope.vars['aw']))
