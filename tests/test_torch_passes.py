"""The pass pipeline of the PyTorch port (fluid/passes: optimize, dce,
fold, cse, amp_pass; fluid/analysis; the executor's PADDLE_TPU_OPT wiring;
InferenceTranspiler) against the JAX package, on the CPU, at small sizes,
with numpy inputs from a seed:

  * the JAX book sweep (tests/test_passes.py:579-613, its non-slow models
    at their kwargs): the same optimized op sequence (type, inputs,
    outputs) and the same PassReport counts as JAX's optimize, and the
    port's PADDLE_TPU_OPT=default bitwise equal to off over 2 steps;
  * the fuzz graphs of tests/test_program_fuzz.py built in both packages:
    the same optimized ops, and default bitwise equal to off;
  * the dropout drill: a dead `exp` AND a dead dropout before a live
    dropout, trained 4 steps, bitwise equal to off (the dead dropout is
    kept, ROADMAP.md Queue C); run_bundle bitwise;
  * the unit drills of the JAX file: DCE's kept print and its producers,
    folding a constant chain (bitwise, on the device given), the cap and
    the generator, CSE's attr-referenced names and undeclared sub-block
    writes, the self-check's fallback (a warning and a passes.error
    event), the cache key, Program.optimize's owned clone;
  * the AMP pass against runtime AMP: each rewritten op (mul, matmul,
    conv2d, flash_attention) within one bf16 ulp of its runtime-AMP
    output, the same rewritten op sequence and report as JAX's, and a
    step of a `_amp_ir` program under amp_guard with ctx.amp off;
  * InferenceTranspiler on a small conv+BN net: the folded weights and
    bias bitwise JAX's, the outputs within 1e-5, the op sequence JAX's;
    memory_optimize / release_memory raise naming the ROADMAP item;
  * obs/report.py's optimizer-passes section over a real run log, equal
    to the JAX summarize of the same records.
"""
import contextlib
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest

import jax  # noqa: F401  (conftest pins it to the CPU)
import jax.numpy as jnp

import paddle_tpu.fluid as jfluid
from paddle_tpu import models as jmodels
from paddle_tpu.fluid import framework as jframework
from paddle_tpu.fluid import passes as jpasses
from paddle_tpu.fluid import unique_name as junique
from paddle_tpu.fluid.executor import Scope as JScope
from paddle_tpu.fluid.executor import _switch_scope as j_switch_scope
from paddle_tpu.obs import report as jreport

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import models as tmodels
from paddle_tpu_torch import obs as tobs
from paddle_tpu_torch.fluid import framework as tframework
from paddle_tpu_torch.fluid import passes as tpasses
from paddle_tpu_torch.fluid import unique_name as tunique
from paddle_tpu_torch.obs import report as treport

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

JAX = (jfluid, jframework, junique)
PORT = (tfluid, tframework, tunique)


@contextlib.contextmanager
def _opt_env(mode):
    prev = os.environ.get(tpasses.ENV_OPT)
    os.environ[tpasses.ENV_OPT] = mode
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop(tpasses.ENV_OPT, None)
        else:
            os.environ[tpasses.ENV_OPT] = prev


def _programs(pkg, build):
    fluid, framework, unique_name = pkg
    main, startup = framework.Program(), framework.Program()
    with unique_name.guard(), framework.program_guard(main, startup):
        out = build(fluid)
    return main, startup, out


def _run_arm(main, startup, feed, fetch_list, mode, n=2, run=None):
    """One A/B arm in the port: a fresh scope and executor (so the run
    counts and the generator's seeds align across arms), `n` runs of the
    same feed under PADDLE_TPU_OPT=mode. Returns (fetches, scope)."""
    with _opt_env(mode):
        sc = tfluid.Scope()
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup, scope=sc)
        if run is not None:
            return run(exe, sc), sc
        return [exe.run(main, feed=feed, fetch_list=fetch_list,
                        scope=sc)[0] for _ in range(n)], sc


def _assert_arms_equal(a, b, what):
    (fa, sa), (fb, sb) = a, b
    for x, y in zip(fa, fb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=what)
    assert set(sa.vars) == set(sb.vars)
    for n in sa.vars:
        np.testing.assert_array_equal(
            sa.to_numpy([n])[n], sb.to_numpy([n])[n],
            err_msg='%s: persistable %s' % (what, n))


def _ops(program):
    return [(op.type,
             {k: [v.name for v in vs] for k, vs in sorted(op.inputs.items())},
             {k: [v.name for v in vs] for k, vs in sorted(op.outputs.items())})
            for op in program.global_block().ops]


# -- the book sweep ------------------------------------------------------------

_SWEEP = {
    'fit_a_line': dict(kwargs=dict(batch_size=4), feeds=['x', 'y']),
    'mnist': dict(kwargs=dict(batch_size=4), feeds=['pixel', 'label'],
                  transform=lambda b: [(np.reshape(i, (1, 28, 28)), l)
                                       for i, l in b]),
    'stacked_dynamic_lstm': dict(
        kwargs=dict(batch_size=2, lstm_size=16, emb_dim=16),
        feeds=['words', 'label']),
    'machine_translation': dict(
        kwargs=dict(batch_size=2, embedding_dim=16, encoder_size=16,
                    decoder_size=16, dict_size=40), feeds_idx=4),
    'transformer': dict(
        kwargs=dict(batch_size=2, max_length=8, n_layer=1, d_model=32,
                    n_head=2, d_inner=32, dict_size=60, warmup_steps=50),
        feeds_idx=4, stack=True),
    'deepfm': dict(kwargs=dict(batch_size=4, embed_dim=4), feeds_idx=4),
    'word2vec': dict(kwargs=dict(batch_size=4), feeds_idx=4),
    'understand_sentiment': dict(kwargs=dict(batch_size=4), feeds_idx=4),
    'label_semantic_roles': dict(
        kwargs=dict(batch_size=2, word_dim=8, mark_dim=2, hidden_dim=16,
                    depth=2), reader_idx=2, feeds_idx=3),
    'recommender_system': dict(
        kwargs=dict(batch_size=4, emb_dim=8, tower_dim=16),
        reader_idx=3, feeds_idx=5),
}


def test_sweep_is_the_jax_sweep_less_its_slow_models():
    slow = {'vgg', 'resnet', 'se_resnext'}
    assert set(_SWEEP) == set(jmodels.model_list) - slow
    assert set(_SWEEP) <= set(tmodels.__all__)


def _book(pkg, name):
    mods = tmodels if pkg is PORT else jmodels
    mod = getattr(mods, name) if pkg is PORT else \
        jmodels.get_model_module(name)
    return _programs(pkg, lambda fluid: mod.get_model(
        **_SWEEP[name]['kwargs']))


def _book_feed(name, main, ret):
    spec = _SWEEP[name]
    reader = ret[spec.get('reader_idx', 2)]
    feeds = spec.get('feeds') or ret[spec['feeds_idx']]
    batch = next(iter(reader()))
    if spec.get('transform'):
        batch = spec['transform'](batch)
    if spec.get('stack'):
        return {n: np.stack([r[i] for r in batch])
                for i, n in enumerate(feeds)}
    feeder = tfluid.DataFeeder(
        place=tfluid.CPUPlace(),
        feed_list=[main.global_block().var(f) for f in feeds])
    return feeder.feed(batch)


@pytest.mark.parametrize('name', sorted(_SWEEP))
def test_book_model_optimized_op_for_op_as_jax(name):
    jmain, _, jret = _book(JAX, name)
    tmain, _, tret = _book(PORT, name)
    jopt, jrep = jpasses.optimize(jmain, fetches=[jret[0].name])
    topt, trep = tpasses.optimize(tmain, fetches=[tret[0].name])
    assert _ops(topt) == _ops(jopt)
    assert trep.to_dict() == jrep.to_dict()
    assert trep.ops_before == len(tmain.global_block().ops)


@pytest.mark.parametrize('name', sorted(_SWEEP))
def test_book_model_default_is_bitwise_off(name):
    """Two training steps, every dropout mask and optimizer update: the
    fetches and every persistable bitwise equal."""
    main, startup, ret = _book(PORT, name)
    feed = _book_feed(name, main, ret)
    a = _run_arm(main, startup, feed, [ret[0]], 'off')
    b = _run_arm(main, startup, feed, [ret[0]], 'default')
    _assert_arms_equal(a, b, name)


def test_label_semantic_roles_drops_its_crf_decode_for_a_cost_fetch():
    main, _, ret = _book(PORT, 'label_semantic_roles')
    c_removed = tobs.REGISTRY.counter('passes.ops_removed')
    before = c_removed.snapshot()['value']
    opt, report = tpasses.optimize(main, fetches=[ret[0].name])
    assert report.ops_after < report.ops_before, report
    assert 'crf_decoding' not in [op.type for op in opt.global_block().ops]
    assert c_removed.snapshot()['value'] == \
        before + report.ops_before - report.ops_after


# -- the fuzz graphs -------------------------------------------------------------

def _unary(layers):
    return [
        lambda v: layers.relu(v),
        lambda v: layers.sigmoid(v),
        lambda v: layers.tanh(v),
        lambda v: layers.scale(v, scale=1.5, bias=0.25),
        lambda v: layers.softmax(v),
        lambda v: layers.abs(v),
        lambda v: layers.elu(v),
        lambda v: layers.l2_normalize(v, axis=-1),
    ]


def _binary(layers):
    return [
        lambda a, b: layers.elementwise_add(a, b),
        lambda a, b: layers.elementwise_mul(a, b),
        lambda a, b: layers.elementwise_max(a, b),
        lambda a, b: layers.elementwise_sub(a, b),
    ]


def _random_graph(layers, rng, x, depth=6):
    """tests/test_program_fuzz.py:_random_graph over either package's
    layers: the same draws give the same graph."""
    unary, binary = _unary(layers), _binary(layers)
    vals = [x]
    for _ in range(depth):
        if len(vals) >= 2 and rng.rand() < 0.4:
            a, b = rng.choice(len(vals), 2, replace=True)
            vals.append(binary[rng.randint(len(binary))](vals[a], vals[b]))
        else:
            v = vals[rng.randint(len(vals))]
            vals.append(unary[rng.randint(len(unary))](v))
    return vals[-1]


def _fuzz(pkg, seed):
    def build(fluid):
        x = fluid.layers.data(name='x', shape=[8], dtype='float32')
        return _random_graph(fluid.layers, np.random.RandomState(seed), x)
    return _programs(pkg, build)


@pytest.mark.parametrize('seed', range(6))
def test_fuzz_graph_optimized_as_jax_and_bitwise_off(seed):
    feed = {'x': np.random.RandomState(100 + seed).randn(4, 8)
            .astype('float32')}
    jmain, _, jout = _fuzz(JAX, seed)
    tmain, tstartup, tout = _fuzz(PORT, seed)
    jopt, jrep = jpasses.optimize(jmain, fetches=[jout.name])
    topt, trep = tpasses.optimize(tmain, fetches=[tout.name])
    assert _ops(topt) == _ops(jopt)
    assert trep.to_dict() == jrep.to_dict()
    a = _run_arm(tmain, tstartup, feed, [tout], 'off', n=1)
    b = _run_arm(tmain, tstartup, feed, [tout], 'default', n=1)
    _assert_arms_equal(a, b, 'fuzz seed %d' % seed)


# -- random ops under DCE --------------------------------------------------------

def _dropout_net(fluid):
    layers = fluid.layers
    x = layers.data(name='x', shape=[8], dtype='float32')
    y = layers.data(name='y', shape=[1], dtype='float32')
    h = layers.fc(input=x, size=16, act='relu')
    layers.exp(h)                              # dead
    layers.dropout(h, dropout_prob=0.5)        # dead, and random
    d = layers.dropout(h, dropout_prob=0.3)
    pred = layers.fc(input=d, size=1)
    cost = layers.mean(layers.square_error_cost(input=pred, label=y))
    fluid.optimizer.SGD(learning_rate=0.05).minimize(cost)
    return cost


def _dropout_feed():
    return {'x': np.random.RandomState(0).rand(8, 8).astype('float32'),
            'y': np.random.RandomState(1).rand(8, 1).astype('float32')}


def test_training_with_a_dead_dropout_before_a_live_one_is_bitwise_off():
    main, startup, cost = _programs(PORT, _dropout_net)
    a = _run_arm(main, startup, _dropout_feed(), [cost], 'off', n=4)
    b = _run_arm(main, startup, _dropout_feed(), [cost], 'default', n=4)
    _assert_arms_equal(a, b, 'dropout drill')
    # the masks really differ run to run (the drill would pass vacuously
    # on a dropout that draws nothing)
    assert len({float(np.asarray(v).reshape(())) for v in a[0]}) == 4


def test_dce_keeps_the_dead_dropout_where_jax_drops_it():
    """ROADMAP.md Queue C: the port's random ops draw in sequence from
    one generator, so DCE keeps a dead random op (and its producers);
    JAX drops it and keeps the other masks by op_seq."""
    jmain, _, jcost = _programs(JAX, _dropout_net)
    tmain, _, tcost = _programs(PORT, _dropout_net)
    jopt, jrep = jpasses.optimize(jmain, fetches=[jcost.name])
    topt, trep = tpasses.optimize(tmain, fetches=[tcost.name])
    jtypes = [op.type for op in jopt.global_block().ops]
    ttypes = [op.type for op in topt.global_block().ops]
    assert 'exp' not in ttypes and 'exp' not in jtypes
    assert jtypes.count('dropout') == 1 and ttypes.count('dropout') == 2
    assert jrep.passes['dce']['ops_removed'] == 2
    assert trep.passes['dce']['ops_removed'] == 1
    ops = [op for op in jopt.global_block().ops]
    assert all(o.attrs['op_seq'] >= i for i, o in enumerate(ops))


def test_run_bundle_default_is_bitwise_off():
    feeds = [{'x': np.random.RandomState(i).rand(4, 8).astype('float32'),
              'y': np.random.RandomState(100 + i).rand(4, 1)
              .astype('float32')} for i in range(4)]
    main, startup, cost = _programs(PORT, _dropout_net)

    def bundle(exe, sc):
        out, = exe.run_bundle(main, feeds=feeds, fetch_list=[cost],
                              scope=sc)
        return [np.asarray(out)]

    a = _run_arm(main, startup, None, None, 'off', run=bundle)
    b = _run_arm(main, startup, None, None, 'default', run=bundle)
    _assert_arms_equal(a, b, 'run_bundle')


# -- unit drills -----------------------------------------------------------------

def test_dce_removes_dead_ops_and_keeps_persistable_writers():
    def build(fluid):
        layers = fluid.layers
        x = layers.data(name='x', shape=[8], dtype='float32')
        y = layers.data(name='y', shape=[1], dtype='float32')
        h = layers.fc(input=x, size=8, act='relu')
        layers.exp(h)
        layers.softmax(h)
        pred = layers.fc(input=h, size=1)
        cost = layers.mean(layers.square_error_cost(input=pred, label=y))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(cost)
        return cost
    main, _, cost = _programs(PORT, build)
    opt, report = tpasses.optimize(main, fetches=[cost.name])
    types = [op.type for op in opt.global_block().ops]
    assert report.passes['dce']['ops_removed'] == 2
    assert 'exp' not in types and 'softmax' not in types
    assert types.count('sgd') == [op.type for op in
                                  main.global_block().ops].count('sgd')
    assert 'autodiff' in types
    # the input program is never mutated
    assert 'exp' in [op.type for op in main.global_block().ops]


def test_dce_kept_print_pins_its_producers():
    def build(fluid):
        layers = fluid.layers
        x = layers.data(name='x', shape=[4], dtype='float32')
        h = layers.scale(x, scale=2.0)
        layers.Print(layers.exp(h), message='kept')
        return layers.relu(x)
    main, _, out = _programs(PORT, build)
    opt, _ = tpasses.optimize(main, fetches=[out.name])
    types = [op.type for op in opt.global_block().ops]
    assert types == ['scale', 'exp', 'print', 'relu']


def _constant_chain(fluid):
    layers = fluid.layers
    x = layers.data(name='x', shape=[4], dtype='float32')
    c = layers.fill_constant(shape=[1, 4], dtype='float32', value=0.5)
    c = layers.exp(layers.scale(c, scale=3.0, bias=0.25))
    return layers.elementwise_add(x, c)


@pytest.mark.parametrize('level', ['default', 'aggressive'])
def test_fold_constant_chain_bitwise(level):
    main, startup, out = _programs(PORT, _constant_chain)
    opt, report = tpasses.optimize(main, fetches=[out.name], level=level,
                                   device='cpu')
    assert report.passes['fold']['ops_folded'] == 2
    types = [op.type for op in opt.global_block().ops]
    assert types == ['assign_value', 'elementwise_add'], types
    feed = {'x': np.random.RandomState(3).rand(2, 4).astype('float32')}
    exe = tfluid.Executor(tfluid.CPUPlace())
    sc = tfluid.Scope()
    exe.run(startup, scope=sc)
    want, = exe.run(main, feed=feed, fetch_list=[out], scope=sc)
    got, = exe.run(opt, feed=feed, fetch_list=[out.name], scope=sc)
    np.testing.assert_array_equal(got, want)
    # the JAX pipeline folds the same two ops
    jmain, _, jout = _programs(JAX, _constant_chain)
    _, jrep = jpasses.optimize(jmain, fetches=[jout.name], level=level)
    assert jrep.to_dict() == report.to_dict()


def test_fold_skips_random_ops_and_respects_the_cap():
    def build(fluid):
        layers = fluid.layers
        big = layers.fill_constant(shape=[100, 100], dtype='float32',
                                   value=1.0)
        big2 = layers.scale(big, scale=2.0)
        r = layers.uniform_random(shape=[4], min=-1.0, max=1.0)
        r2 = layers.scale(r, scale=2.0)
        return big2, r2
    main, _, (big2, r2) = _programs(PORT, build)
    _, rep = tpasses.optimize(main, fetches=[big2.name, r2.name])
    assert rep.passes['fold']['ops_folded'] == 0   # 10,000 > 4,096
    _, rep = tpasses.optimize(main, fetches=[big2.name, r2.name],
                              level='aggressive')
    assert rep.passes['fold']['ops_folded'] == 1   # the random op stays
    assert tpasses.uses_rng(main.global_block().ops[2])
    assert not tpasses.is_pure(main.global_block().ops[2])


def test_cse_merges_duplicates_but_never_random_ops():
    def build(fluid):
        layers = fluid.layers
        x = layers.data(name='x', shape=[8], dtype='float32')
        a = layers.elementwise_add(layers.tanh(x), layers.tanh(x))
        d1 = layers.dropout(x, dropout_prob=0.5)
        d2 = layers.dropout(x, dropout_prob=0.5)
        return layers.elementwise_add(a, layers.elementwise_add(d1, d2))
    jmain, _, jout = _programs(JAX, build)
    main, startup, out = _programs(PORT, build)
    opt, rep = tpasses.optimize(main, fetches=[out.name])
    _, jrep = jpasses.optimize(jmain, fetches=[jout.name])
    assert rep.passes['cse']['ops_merged'] == 1
    assert rep.to_dict() == jrep.to_dict()
    types = [op.type for op in opt.global_block().ops]
    assert types.count('tanh') == 1 and types.count('dropout') == 2
    feed = {'x': np.random.RandomState(5).rand(3, 8).astype('float32')}
    a = _run_arm(main, startup, feed, [out], 'off', n=2)
    b = _run_arm(main, startup, feed, [out], 'default', n=2)
    _assert_arms_equal(a, b, 'cse drill')


def test_cse_protects_fetched_and_attr_referenced_names():
    def build(fluid):
        layers = fluid.layers
        x = layers.data(name='x', shape=[8], dtype='float32')
        t1, t2 = layers.tanh(x), layers.tanh(x)
        return t1, t2, layers.elementwise_add(t1, t2)
    main, _, (t1, t2, out) = _programs(PORT, build)
    _, rep = tpasses.optimize(main, fetches=[out.name, t2.name])
    assert rep.passes['cse']['ops_merged'] == 0
    _, rep = tpasses.optimize(main, fetches=[out.name])
    assert rep.passes['cse']['ops_merged'] == 1


def _undeclared_write_loop(fluid, main, target):
    """The JAX tests/test_passes.py:242 helper over either package: a
    hand-appended `while` whose body writes `target` without listing it
    among the op's outputs."""
    cond = fluid.layers.fill_constant(shape=[1], dtype='bool', value=False)
    sub = main.create_block()
    five = sub.create_var(name='five@sbw', shape=[1], dtype='float32')
    sub.append_op(type='fill_constant', inputs={}, outputs={'Out': [five]},
                  attrs={'shape': [1], 'dtype': 'float32', 'value': 5.0},
                  infer_shape=False)
    sub.append_op(type='assign', inputs={'X': [five]},
                  outputs={'Out': [target]}, infer_shape=False)
    main.rollback()
    return main.current_block().append_op(
        type='while', inputs={'Condition': [cond], 'X': []},
        outputs={'Out': [cond]}, attrs={'sub_block': sub.idx},
        infer_shape=False)


def _sub_block_cse(fluid):
    layers = fluid.layers
    main = fluid.default_main_program()
    w = layers.create_global_var(shape=[1], value=3.0, dtype='float32',
                                 persistable=True, name='w@sbw')
    pre = layers.scale(w, scale=2.0)
    _undeclared_write_loop(fluid, main, w)
    post = layers.scale(w, scale=2.0)
    return layers.elementwise_add(pre, post)


def _sub_block_amp(fluid):
    layers = fluid.layers
    main = fluid.default_main_program()
    x = layers.data(name='x', shape=[4], dtype='float32')
    w = layers.create_global_var(shape=[4, 4], value=1.0, dtype='float32',
                                 persistable=True, name='amp_w@sbw')
    a = layers.matmul(x, w)
    _undeclared_write_loop(fluid, main, w)
    b = layers.matmul(x, w)
    fluid.amp.decorate_program(main)
    return layers.elementwise_add(a, b)


@pytest.mark.parametrize('build', [_sub_block_cse, _sub_block_amp])
def test_passes_see_undeclared_sub_block_writes(build):
    """Two reads straddling a sub-block that writes their input without
    declaring it: CSE must not merge them, and the AMP rewrite must cast
    w again (the JAX tests/test_passes.py:262-301)."""
    jmain, _, jout = _programs(JAX, build)
    tmain, _, tout = _programs(PORT, build)
    jopt, jrep = jpasses.optimize(jmain, fetches=[jout.name])
    topt, trep = tpasses.optimize(tmain, fetches=[tout.name])
    assert _ops(topt) == _ops(jopt)
    assert trep.to_dict() == jrep.to_dict()
    types = [op.type for op in topt.global_block().ops]
    if build is _sub_block_cse:
        assert trep.passes['cse']['ops_merged'] == 0
        assert types.count('scale') == 2
    else:
        casts = [op for op in topt.global_block().ops if op.type == 'cast'
                 and op.input_arg_names == ['amp_w@sbw']]
        assert len(casts) == 2


def test_a_failing_pass_falls_back_loudly(monkeypatch, tmp_path):
    """The optimizer's failure warns, emits passes.error and runs the
    unoptimized program; the report counts it."""
    main, startup, cost = _programs(PORT, _dropout_net)
    from paddle_tpu_torch.fluid.passes import cse

    def boom(*a, **k):
        raise RuntimeError('injected pass failure')

    monkeypatch.setattr(cse, 'run', boom)
    errors = tobs.REGISTRY.counter('passes.errors').snapshot()['value']
    tobs.enable(str(tmp_path / 'obs'))
    try:
        sc = tfluid.Scope()
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup, scope=sc)
        with _opt_env('default'), warnings.catch_warnings(record=True) as w:
            warnings.simplefilter('always')
            got = exe.run(main, feed=_dropout_feed(), fetch_list=[cost],
                          scope=sc)[0]
        path = tobs.run_log_path()
    finally:
        tobs._reset()
    assert any('injected pass failure' in str(x.message) for x in w)
    assert tobs.REGISTRY.counter('passes.errors').snapshot()['value'] \
        == errors + 1
    events, errs = treport.load_events(path)
    assert errs == []
    fails = [e for e in events if e['name'] == 'passes.error']
    assert len(fails) == 1 and 'injected' in fails[0]['fields']['error']
    assert '1 optimizer failure(s) fell back' in treport.summarize(events)
    a = _run_arm(main, startup, _dropout_feed(), [cost], 'off', n=1)
    np.testing.assert_array_equal(got, a[0][0])


def test_the_pass_level_is_part_of_the_cache_key_and_runs_once():
    main, startup, cost = _programs(PORT, _dropout_net)
    sc = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=sc)
    c = tobs.REGISTRY.counter('passes.programs_optimized')
    n0 = c.snapshot()['value']
    with _opt_env('default'):
        for _ in range(3):
            exe.run(main, feed=_dropout_feed(), fetch_list=[cost], scope=sc)
    assert c.snapshot()['value'] == n0 + 1
    m = exe.cache_stats['misses']
    with _opt_env('off'):
        exe.run(main, feed=_dropout_feed(), fetch_list=[cost], scope=sc)
    assert exe.cache_stats['misses'] == m + 1
    with _opt_env('default'):
        exe.run(main, feed=_dropout_feed(), fetch_list=[cost], scope=sc)
    assert exe.cache_stats['misses'] == m + 1
    assert c.snapshot()['value'] == n0 + 1
    with _opt_env('bogus'), pytest.raises(ValueError, match='off|default'):
        tpasses.opt_mode()


def test_program_optimize_returns_an_owned_clone():
    main, _, cost = _programs(PORT, _dropout_net)
    p = main.optimize(fetches=[cost.name])
    assert p is not main and p._opt_report.ops_after < len(
        main.global_block().ops)
    q = main.optimize(level='off')
    assert q is not main and q._opt_report.skipped == 'level=off'
    assert [op.type for op in q.global_block().ops] == \
        [op.type for op in main.global_block().ops]
    with pytest.raises(ValueError, match='level'):
        main.optimize(level='max')


def test_analysis_live_mask_and_run_pass_are_the_jax_ones():
    from paddle_tpu.fluid.analysis import dataflow as jdf
    from paddle_tpu_torch.fluid import analysis as tanalysis
    jmain, _, jcost = _programs(JAX, _dropout_net)
    tmain, _, tcost = _programs(PORT, _dropout_net)
    blk_j, blk_t = jmain.global_block(), tmain.global_block()
    assert tanalysis.live_mask(tmain, blk_t, {tcost.name}) == \
        jdf.live_mask(jmain, blk_j, {jcost.name})
    jf = jdf.run_pass(jmain, fetches=[jcost.name, 'nothing'])
    tf = tanalysis.run_pass(tmain, fetches=[tcost.name, 'nothing'])
    # the JAX package records build-site provenance; the port none

    def strip(f):
        d = f.to_dict()
        d.pop('callsite')
        return d
    assert [strip(f) for f in tf] == [strip(f) for f in jf]
    assert {f.kind for f in tf} == {'UnreachableFetch', 'DeadOp'}
    assert tanalysis.executor_write_set(tmain) == \
        {v.name for v in tmain.list_vars() if v.persistable
         and v.name not in ('x', 'y')
         and any(v.name in op.output_arg_names for op in blk_t.ops)}


# -- the AMP pass ----------------------------------------------------------------

def _amp_net(fluid):
    layers = fluid.layers
    x = layers.data(name='x', shape=[6, 16], dtype='float32')
    img = layers.data(name='img', shape=[3, 8, 8], dtype='float32')
    q = layers.data(name='q', shape=[2, 8, 16], dtype='float32')
    k = layers.data(name='k', shape=[2, 8, 16], dtype='float32')
    v = layers.data(name='v', shape=[2, 8, 16], dtype='float32')
    fc = layers.fc(input=x, size=12, num_flatten_dims=2)
    mm = layers.matmul(x, x, transpose_y=True)
    conv = layers.conv2d(img, num_filters=4, filter_size=3)
    att = layers.fused_attention(q, k, v)
    return fc, mm, conv, att


def _amp_feed():
    rng = np.random.RandomState(11)
    return {'x': rng.randn(2, 6, 16).astype('float32'),
            'img': rng.randn(2, 3, 8, 8).astype('float32'),
            'q': rng.randn(2, 2, 8, 16).astype('float32'),
            'k': rng.randn(2, 2, 8, 16).astype('float32'),
            'v': rng.randn(2, 2, 8, 16).astype('float32')}


def _bf16_ulp(x):
    """One bf16 ulp of each element of x (2^(exponent - 7))."""
    a = np.abs(np.asarray(x, np.float64))
    e = np.floor(np.log2(np.where(a > 0, a, 1.0)))
    return np.where(a > 0, 2.0 ** (e - 7), 2.0 ** -133)


def test_amp_pass_is_within_one_bf16_ulp_of_runtime_amp_per_op():
    main, startup, outs = _programs(PORT, _amp_net)
    tfluid.amp.decorate_program(main)
    fetch = [o.name for o in outs]
    sc = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=sc)
    runtime = exe.run(main, feed=_amp_feed(), fetch_list=fetch, scope=sc)
    opt, rep = tpasses.optimize(main, fetches=fetch)
    assert getattr(opt, '_amp_ir', False) and not opt._amp
    assert rep.passes['amp']['ops_rewritten'] == len(outs)
    assert rep.passes['amp']['ops_skipped'] == 0
    rewritten = exe.run(opt, feed=_amp_feed(), fetch_list=fetch, scope=sc)
    for name, r, g in zip(fetch, runtime, rewritten):
        assert g.dtype == np.float32, name
        d = np.abs(np.asarray(g, np.float64) - np.asarray(r, np.float64))
        assert (d <= _bf16_ulp(r)).all(), (name, float(d.max()))
    # and the rewrite really moved the products off fp32
    f32 = main.clone()
    f32._amp = False
    exe_f32 = exe.run(f32, feed=_amp_feed(), fetch_list=fetch, scope=sc)
    assert not np.array_equal(exe_f32[0], runtime[0])


def test_amp_rewrite_is_the_jax_rewrite():
    def build(fluid):
        fc, mm, conv, _ = _amp_net(fluid)
        return fc, mm, conv
    jmain, _, jouts = _programs(JAX, build)
    tmain, _, touts = _programs(PORT, build)
    jfluid.amp.decorate_program(jmain)
    tfluid.amp.decorate_program(tmain)
    jopt, jrep = jpasses.optimize(jmain, fetches=[o.name for o in jouts])
    topt, trep = tpasses.optimize(tmain, fetches=[o.name for o in touts])
    assert _ops(topt) == _ops(jopt)
    assert trep.to_dict() == jrep.to_dict()
    jv = {v.name: (v.dtype, v.shape) for v in jopt.list_vars()}
    tv = {v.name: (v.dtype, v.shape) for v in topt.list_vars()}
    assert tv == jv


def test_an_amp_ir_program_runs_with_ctx_amp_off_under_amp_guard():
    main, startup, outs = _programs(PORT, _amp_net)
    tfluid.amp.decorate_program(main)
    fetch = [o.name for o in outs]
    opt, _ = tpasses.optimize(main, fetches=fetch)
    sc = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=sc)
    plain = exe.run(opt, feed=_amp_feed(), fetch_list=fetch, scope=sc)
    with tfluid.amp.amp_guard():
        guarded = exe.run(opt, feed=_amp_feed(), fetch_list=fetch, scope=sc)
        art = exe.step_artifact(opt, _amp_feed(), fetch, scope=sc)
    assert not art.amp
    for a, b in zip(plain, guarded):
        np.testing.assert_array_equal(a, b)


def test_amp_pass_through_the_executor_is_within_a_bf16_ulp_of_runtime():
    """PADDLE_TPU_OPT=default on an AMP-decorated training program: the
    step-1 loss within one bf16 ulp of runtime AMP's."""
    def build(fluid):
        layers = fluid.layers
        x = layers.data(name='x', shape=[16], dtype='float32')
        y = layers.data(name='y', shape=[1], dtype='float32')
        h = layers.fc(input=x, size=32, act='tanh')
        pred = layers.fc(input=h, size=1)
        cost = layers.mean(layers.square_error_cost(input=pred, label=y))
        fluid.optimizer.Adam(learning_rate=1e-2).minimize(cost)
        return cost
    main, startup, cost = _programs(PORT, build)
    tfluid.amp.decorate_program(main)
    rng = np.random.RandomState(2)
    feed = {'x': rng.randn(8, 16).astype('float32'),
            'y': rng.randn(8, 1).astype('float32')}
    a, _ = _run_arm(main, startup, feed, [cost], 'off', n=1)
    b, _ = _run_arm(main, startup, feed, [cost], 'default', n=1)
    d = abs(float(a[0].reshape(())) - float(b[0].reshape(())))
    assert d <= float(_bf16_ulp(a[0].reshape(()))), d


# -- InferenceTranspiler ---------------------------------------------------------

def _conv_bn_net(fluid):
    layers = fluid.layers
    img = layers.data(name='img', shape=[3, 8, 8], dtype='float32')
    c = layers.conv2d(img, num_filters=4, filter_size=3, bias_attr=False)
    b = layers.batch_norm(c, act='relu', is_test=True)
    c2 = layers.conv2d(b, num_filters=5, filter_size=3, bias_attr=False)
    return layers.batch_norm(c2, is_test=True)


def test_inference_transpiler_folds_as_jax_bitwise():
    rng = np.random.RandomState(4)
    jmain, jstartup, jout = _programs(JAX, _conv_bn_net)
    tmain, _, tout = _programs(PORT, _conv_bn_net)
    jscope = JScope()
    prev = j_switch_scope(jscope)
    try:
        jexe = jfluid.Executor(jfluid.CPUPlace())
        jexe.run(jstartup)
    finally:
        j_switch_scope(prev)
    state = {}
    for v in jmain.list_vars():
        if v.persistable:
            a = np.asarray(jscope.vars[v.name])
            if 'mean' in v.name or 'variance' in v.name or \
                    'scale' in v.name or v.name.endswith('.b_0'):
                a = (rng.rand(*a.shape) + 0.5).astype('float32')
            state[v.name] = a
            jscope.vars[v.name] = jnp.asarray(a)
    tscope = tfluid.Scope()
    tscope.load_numpy(state, tfluid.CPUPlace())
    feed = {'img': rng.randn(2, 3, 8, 8).astype('float32')}
    exe = tfluid.Executor(tfluid.CPUPlace())
    before, = exe.run(tmain, feed=feed, fetch_list=[tout], scope=tscope)
    with pytest.warns(DeprecationWarning, match='fold_batch_norm'):
        jfluid.InferenceTranspiler().transpile(jmain, jfluid.CPUPlace(),
                                               scope=jscope)
    with pytest.warns(DeprecationWarning, match='fold_batch_norm'):
        tfluid.InferenceTranspiler().transpile(tmain, tfluid.CPUPlace(),
                                               scope=tscope)
    assert _ops(tmain) == _ops(jmain)
    assert [op.type for op in tmain.global_block().ops] == \
        ['conv2d', 'elementwise_add', 'relu', 'conv2d', 'elementwise_add']
    folded = [n for n in tscope.vars if n.endswith('.bnfold_bias')]
    assert len(folded) == 2
    for op in tmain.global_block().ops:
        if op.type == 'conv2d':
            folded.append(op.inputs['Filter'][0].name)
    for n in folded:
        np.testing.assert_array_equal(tscope.to_numpy([n])[n],
                                      np.asarray(jscope.vars[n]), err_msg=n)
    after, = exe.run(tmain, feed=feed, fetch_list=[tout], scope=tscope)
    np.testing.assert_allclose(after, before, rtol=1e-5, atol=1e-5)


def test_memory_optimize_and_release_memory_name_the_roadmap_item():
    main, _, _ = _programs(PORT, _dropout_net)
    for fn in (tfluid.memory_optimize, tfluid.release_memory):
        with pytest.raises(NotImplementedError,
                           match='Analysis and tooling'):
            fn(main)


# -- the report ------------------------------------------------------------------

def test_report_passes_section_over_a_real_run_log(tmp_path):
    main, startup, cost = _programs(PORT, _dropout_net)
    tobs.enable(str(tmp_path / 'obs'))
    try:
        with _opt_env('default'):
            sc = tfluid.Scope()
            exe = tfluid.Executor(tfluid.CPUPlace())
            exe.run(startup, scope=sc)
            for _ in range(2):
                exe.run(main, feed=_dropout_feed(), fetch_list=[cost],
                        scope=sc)
        path = tobs.run_log_path()
    finally:
        tobs._reset()
    events, errs = treport.load_events(path)
    assert errs == []
    spans = [e for e in events if e['name'] == 'passes.optimize']
    # the startup program and the main program, each once
    assert len(spans) == 2
    names = {e['name'] for e in events}
    for n in ('passes.fold', 'passes.cse', 'passes.dce'):
        assert n in names, n
    text = treport.summarize(events)
    assert text == jreport.summarize(jreport.load_events(path)[0])
    n_main = len(main.global_block().ops)
    n_start = len(startup.global_block().ops)
    assert '-- optimizer passes --' in text
    assert '2 program(s) optimized: %d -> %d top-level op(s)' % (
        n_main + n_start, n_main + n_start - 1) in text
    assert 'per pass: dce=1' in text


def test_new_modules_import_without_jax():
    mods = ['paddle_tpu_torch.fluid.analysis',
            'paddle_tpu_torch.fluid.analysis.dataflow',
            'paddle_tpu_torch.fluid.analysis.findings',
            'paddle_tpu_torch.fluid.passes.dce',
            'paddle_tpu_torch.fluid.passes.fold',
            'paddle_tpu_torch.fluid.passes.cse',
            'paddle_tpu_torch.fluid.passes.amp_pass',
            'paddle_tpu_torch.fluid.passes.quant_pass',
            'paddle_tpu_torch.fluid.ops_impl.quant_ops',
            'paddle_tpu_torch.fluid.transpiler',
            'paddle_tpu_torch.embedding.quant_rows']
    code = ('import sys\n'
            'for m in %r:\n'
            '    __import__(m)\n'
            'bad = sorted(m for m in sys.modules if m == "jax" '
            'or m.startswith("jax.") or m == "paddle_tpu" '
            'or m.startswith("paddle_tpu."))\n'
            'assert not bad, bad\n'
            'print("clean")\n' % (mods,))
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == 'clean'
