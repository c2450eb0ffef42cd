"""The port's image and book models (models/fit_a_line.py, mnist.py,
resnet.py), their readers and the DataFeeder against the JAX package's, on
the CPU, at tiny shapes:

  * get_model emits the JAX program op for op, startup program too:
    fit_a_line, MNIST LeNet, resnet_cifar10(depth=8),
    resnet_imagenet(depth=50), VGG-16 on cifar10 and SE-ResNeXt-50
    (building compiles nothing);
  * from the JAX package's startup scope carried into the port: fit_a_line
    params after 3 SGD steps (1e-5 of each tensor's max |w|); MNIST at
    batch 8, losses over 3 Adam steps (1e-4); resnet_cifar10(depth=8) at
    batch 4, losses and every persistable (running stats, velocities)
    over 3 Momentum steps (1e-4 of max(|x|, 1)); one bottleneck stage at
    16x16, batch 2, NCHW and NHWC, the same;
  * a resume: the JAX scope after 2 Momentum steps (params, velocities,
    running stats), carried whole into the port through
    Scope.load_numpy, gives JAX's step 3;
  * the for_test clone of a batch-norm net, saved by one package and
    loaded by the other's Predictor, gives the same answers (1e-5), and
    concurrent ServingEngine requests leave its running stats bitwise
    unchanged;
  * the port's uci_housing, mnist, cifar and flowers (test mapper)
    readers, reader decorators and DataFeeder give the JAX package's
    samples and arrays bitwise.
"""
import concurrent.futures
import random

import numpy as np
import pytest

import jax  # noqa: F401  (conftest pins it to the CPU)

import paddle_tpu as jpaddle
import paddle_tpu.fluid as jfluid
from paddle_tpu import inference as jinference
from paddle_tpu.fluid import framework as jframework
from paddle_tpu.fluid import unique_name as junique
from paddle_tpu.fluid.executor import Scope as JScope
from paddle_tpu.models import fit_a_line as jfit
from paddle_tpu.models import mnist as jmnist
from paddle_tpu.models import resnet as jresnet
from paddle_tpu.models import se_resnext as jse_resnext
from paddle_tpu.models import vgg as jvgg

import paddle_tpu_torch as tpaddle
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import inference as tinference
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.fluid import framework as tframework
from paddle_tpu_torch.fluid import unique_name as tunique
from paddle_tpu_torch.models import fit_a_line as tfit
from paddle_tpu_torch.models import mnist as tmnist
from paddle_tpu_torch.models import resnet as tresnet
from paddle_tpu_torch.models import se_resnext as tse_resnext
from paddle_tpu_torch.models import vgg as tvgg

from test_torch_training import _assert_same_program

JAX = (jpaddle, jfluid, jframework, junique,
       dict(fit=jfit, mnist=jmnist, resnet=jresnet, vgg=jvgg,
            se_resnext=jse_resnext))
PORT = (tpaddle, tfluid, tframework, tunique,
        dict(fit=tfit, mnist=tmnist, resnet=tresnet, vgg=tvgg,
             se_resnext=tse_resnext))
TOL = 1e-4
VELOCITY_TOL = 1e-2


def _build(pkg, model, **kw):
    """One of the models in fresh programs; returns (main, startup, the
    builder's return value)."""
    _, fluid, framework, unique_name, models = pkg
    main, startup = framework.Program(), framework.Program()
    with unique_name.guard(), framework.program_guard(main, startup):
        if model == 'fit':
            out = models['fit'].get_model(**kw)
        elif model == 'mnist':
            out = models['mnist'].get_model(**kw)
        elif model in ('vgg', 'se_resnext'):
            out = models[model].get_model(**kw)
        elif model in ('cifar8', 'imagenet50'):
            out = models['resnet'].get_model(
                data_set='cifar10' if model == 'cifar8' else 'imagenet',
                depth=8 if model == 'cifar8' else 50, **kw)
        else:
            out = _bottleneck_net(fluid, models['resnet'], **kw)
    return main, startup, out


def _bottleneck_net(fluid, resnet, fmt='NCHW'):
    """One bottleneck stage (stride 2, a projection shortcut) on 8x16x16
    inputs, global average pool, softmax fc over 5 classes,
    Momentum(0.05, 0.9)."""
    shape = [8, 16, 16] if fmt == 'NCHW' else [16, 16, 8]
    x = fluid.layers.data(name='x', shape=shape)
    label = fluid.layers.data(name='label', shape=[1], dtype='int64')
    y = resnet.bottleneck(x, 4, 2, data_format=fmt)
    pool = fluid.layers.pool2d(y, pool_type='avg', global_pooling=True,
                               data_format=fmt)
    prob = fluid.layers.fc(pool, size=5, act='softmax')
    loss = fluid.layers.mean(fluid.layers.cross_entropy(prob, label))
    fluid.optimizer.Momentum(learning_rate=0.05, momentum=0.9).minimize(loss)
    return loss, prob


@pytest.mark.parametrize('which', ['main', 'startup'])
@pytest.mark.parametrize('model', ['fit', 'mnist', 'cifar8', 'imagenet50',
                                   'vgg', 'se_resnext'])
def test_get_model_emits_the_jax_program(model, which):
    i = 0 if which == 'main' else 1
    j, t = _build(JAX, model)[i], _build(PORT, model)[i]
    _assert_same_program(j, t)
    types = [op.type for op in t.global_block().ops]
    if which == 'main' and model == 'imagenet50':
        assert types.count('conv2d') == 53
        assert types.count('batch_norm') == 53
        assert types.count('pool2d') == 2
        assert types.count('momentum') == 161
        for op_type in ('softmax', 'cross_entropy', 'top_k', 'accuracy',
                        'autodiff'):
            assert op_type in types, op_type
    if which == 'main' and model == 'mnist':
        assert types.count('conv2d') == 2 and 'adam' in types
    if which == 'main' and model == 'vgg':
        assert types.count('conv2d') == 13
        assert types.count('batch_norm') == 14
        assert types.count('dropout') == 10 and 'adam' in types
    if which == 'main' and model == 'se_resnext':
        convs = [op for op in t.global_block().ops if op.type == 'conv2d']
        assert len(convs) == 53
        assert sum(op.attrs['groups'] == 32 for op in convs) == 16
        assert types.count('momentum') == 161 + 64


@pytest.mark.parametrize('fmt', ['NCHW', 'NHWC'])
def test_bottleneck_program_is_the_jax_program(fmt):
    for i in (0, 1):
        _assert_same_program(_build(JAX, 'bottleneck', fmt=fmt)[i],
                             _build(PORT, 'bottleneck', fmt=fmt)[i])


# -- training from the same weights ----------------------------------------

def _jax_train(model, feeds, fetch, **kw):
    """JAX training from its own startup; returns (startup scope, the
    fetches of each step, the scope after each step), as numpy."""
    main, startup, _ = _build(JAX, model, **kw)
    scope = JScope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(startup)
        init = {n: np.array(v, copy=True) for n, v in scope.vars.items()}
        outs, scopes = [], []
        for feed in feeds:
            outs.append([np.array(a) for a in
                         exe.run(main, feed=feed, fetch_list=fetch)])
            scopes.append({n: np.array(v, copy=True)
                           for n, v in scope.vars.items()})
    return init, outs, scopes


def _port_train(model, state, feeds, fetch, **kw):
    main = _build(PORT, model, **kw)[0]
    scope = tfluid.Scope()
    scope.load_numpy(state, tfluid.CPUPlace())
    exe = tfluid.Executor(tfluid.CPUPlace())
    outs = [exe.run(main, feed=f, fetch_list=fetch, scope=scope)
            for f in feeds]
    return outs, scope


def _assert_scope(scope, want, tol, floor=1.0):
    got = scope.to_numpy(sorted(want))
    for n, w in want.items():
        assert got[n].shape == w.shape, n
        scale = max(float(np.abs(w).max()), floor)
        np.testing.assert_allclose(got[n], w, rtol=0, atol=tol * scale,
                                   err_msg=n)


def _image_feeds(main, data_shape, reader, batch, n_steps):
    it = tpaddle.batch(reader, batch)()
    blk = main.global_block()
    feeder = tfluid.DataFeeder([blk.var('data'), blk.var('label')],
                               tfluid.CPUPlace())
    out = []
    for _ in range(n_steps):
        f = feeder.feed(next(it))
        assert f['data'].shape == (batch,) + tuple(data_shape)
        out.append(f)
    return out


def test_fit_a_line_params_after_three_sgd_steps():
    main, _, (cost, _, _, _, names) = _build(PORT, 'fit')
    blk = main.global_block()
    feeder = tfluid.DataFeeder([blk.var(n) for n in names],
                               tfluid.CPUPlace())
    it = tpaddle.batch(tpaddle.dataset.uci_housing.train(), 20)()
    feeds = [feeder.feed(next(it)) for _ in range(3)]
    init, jout, jscopes = _jax_train('fit', feeds, [cost.name])
    tout, scope = _port_train('fit', init, feeds, [cost.name])
    np.testing.assert_allclose([float(o[0][0]) for o in tout],
                               [float(o[0][0]) for o in jout], rtol=1e-5)
    params = [p.name for p in main.all_parameters()]
    _assert_scope(scope, {n: jscopes[-1][n] for n in params}, 1e-5,
                  floor=1e-12)
    assert all(not np.array_equal(jscopes[-1][n], init[n]) for n in params)


def test_mnist_losses_over_three_adam_steps():
    main, _, (cost, _, _, _, acc) = _build(PORT, 'mnist')
    blk = main.global_block()
    feeder = tfluid.DataFeeder([blk.var('pixel'), blk.var('label')],
                               tfluid.CPUPlace())
    it = tpaddle.batch(tpaddle.dataset.mnist.train(), 8)()
    feeds = [feeder.feed(next(it)) for _ in range(3)]
    assert feeds[0]['pixel'].shape == (8, 1, 28, 28)
    init, jout, _ = _jax_train('mnist', feeds, [cost.name, acc.name])
    tout, _ = _port_train('mnist', init, feeds, [cost.name, acc.name])
    jl = [float(o[0][0]) for o in jout]
    np.testing.assert_allclose([float(o[0][0]) for o in tout], jl,
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose([float(o[1][0]) for o in tout],
                               [float(o[1][0]) for o in jout])
    assert abs(jl[2] - jl[0]) > 1e-3


@pytest.fixture(scope='module')
def cifar_runs():
    main, _, (cost, acc, _, _) = _build(PORT, 'cifar8')
    feeds = _image_feeds(main, (3, 32, 32),
                         tpaddle.dataset.cifar.train10(), 4, 3)
    ad = [op for op in main.global_block().ops if op.type == 'autodiff']
    fetch = [cost.name, acc.name] + list(ad[0].attrs['grad_names'])
    init, jout, jscopes = _jax_train('cifar8', feeds, fetch)
    return feeds, fetch, init, jout, jscopes


def _stats(names):
    return [n for n in names if 'batch_norm' in n
            and ('.w_1' in n or '.w_2' in n)]


def _assert_trained_scope(scope, want):
    """Every persistable within TOL of max(|x|, 1), but the velocities.
    A velocity holds the step's raw gradient, and a ReLU whose input lies
    within rounding of 0 takes the other branch in the other package
    (one unit of 32,768 in resnet_cifar10's res2 output at step 3), which
    moves a few elements upstream of it by their full size: each velocity
    is held by its difference's L2 norm, within VELOCITY_TOL of its own
    (the measure chip_smoke.py holds card against CPU gradients to)."""
    vel = {n: w for n, w in want.items() if n.startswith('velocity_')}
    _assert_scope(scope, {n: w for n, w in want.items() if n not in vel},
                  TOL)
    got = scope.to_numpy(sorted(vel))
    for n, w in vel.items():
        norm = float(np.linalg.norm(w))
        assert float(np.linalg.norm(got[n] - w)) <= VELOCITY_TOL * norm, n


def test_resnet_cifar10_over_three_momentum_steps(cifar_runs):
    feeds, fetch, init, jout, jscopes = cifar_runs
    stats = _stats(init)
    # depth 8: the stem, 2 a basic block, 2 projection shortcuts
    assert len(stats) == 2 * 9
    assert all(np.all(init[n] == (0.0 if n.endswith('.w_1') else 1.0))
               for n in stats)
    tout, scope = _port_train('cifar8', init, feeds, fetch)
    jl = [float(o[0][0]) for o in jout]
    np.testing.assert_allclose([float(o[0][0]) for o in tout], jl,
                               rtol=TOL, atol=TOL)
    assert abs(jl[2] - jl[0]) > 1e-3
    # step 1: every gradient within TOL of its max |g|
    assert len(fetch) - 2 == 29           # 9 convs, 9 batch norms, the fc
    for name, j, t in zip(fetch[2:], jout[0][2:], tout[0][2:]):
        scale = max(float(np.abs(j).max()), 1e-12)
        np.testing.assert_allclose(t, j, rtol=0, atol=TOL * scale,
                                   err_msg=name)
    # after step 3: params, running stats (moved off their initial 0 and 1
    # by the forward's write-back), the lr, the velocities
    _assert_trained_scope(scope, jscopes[-1])
    got = scope.to_numpy(stats)
    assert all(not np.array_equal(got[n], init[n]) for n in stats)
    assert sum(n.startswith('velocity_') for n in jscopes[-1]) == 29
    assert not any(v.requires_grad for v in scope.vars.values())


def test_run_resumes_across_packages(cifar_runs):
    """The JAX scope after 2 steps, carried whole into the port (params,
    velocities, running stats), gives JAX's step 3."""
    feeds, fetch, _, jout, jscopes = cifar_runs
    tout, scope = _port_train('cifar8', jscopes[1], feeds[2:], fetch[:2])
    assert abs(float(tout[0][0][0]) - float(jout[2][0][0])) < TOL
    _assert_trained_scope(scope, jscopes[2])


@pytest.mark.parametrize('fmt', ['NCHW', 'NHWC'])
def test_bottleneck_stage_trains_as_the_jax_one(fmt):
    main, _, (loss, _) = _build(PORT, 'bottleneck', fmt=fmt)
    r = np.random.RandomState(5)
    shape = (2, 8, 16, 16) if fmt == 'NCHW' else (2, 16, 16, 8)
    feeds = [{'x': r.randn(*shape).astype('float32'),
              'label': r.randint(0, 5, (2, 1)).astype('int64')}
             for _ in range(3)]
    init, jout, jscopes = _jax_train('bottleneck', feeds, [loss.name],
                                     fmt=fmt)
    tout, scope = _port_train('bottleneck', init, feeds, [loss.name],
                              fmt=fmt)
    np.testing.assert_allclose([float(o[0][0]) for o in tout],
                               [float(o[0][0]) for o in jout],
                               rtol=TOL, atol=TOL)
    _assert_scope(scope, jscopes[-1], TOL)


# -- inference across packages ---------------------------------------------

@pytest.fixture(scope='module')
def bn_state():
    """The NCHW bottleneck net after 2 training steps in the port (running
    stats off their initial values): (main, prob name, scope as numpy,
    a request)."""
    main, startup, (loss, prob) = _build(PORT, 'bottleneck')
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    r = np.random.RandomState(6)
    for _ in range(2):
        exe.run(main, feed={'x': r.randn(4, 8, 16, 16).astype('float32'),
                            'label': r.randint(0, 5, (4, 1))},
                fetch_list=[loss], scope=scope)
    req = {'x': r.randn(3, 8, 16, 16).astype('float32')}
    return main, prob.name, scope.to_numpy(), req


@pytest.mark.parametrize('saved_by', ['jax', 'port'])
def test_inference_artifact_crosses_packages(bn_state, saved_by, tmp_path):
    tmain, prob, state, req = bn_state
    jmain = _build(JAX, 'bottleneck')[0]
    jtest, ttest = jmain.clone(for_test=True), tmain.clone(for_test=True)
    assert [op.attrs['is_test'] for op in ttest.global_block().ops
            if op.type == 'batch_norm'] == [True] * 4
    d = str(tmp_path)
    if saved_by == 'jax':
        jscope = JScope()
        with jfluid.scope_guard(jscope):
            for n, a in state.items():
                jscope.vars[n] = a
            jfluid.io.save_inference_model(
                d, ['x'], [jtest.global_block().var(prob)],
                jfluid.Executor(jfluid.CPUPlace()), main_program=jtest)
    else:
        scope = tfluid.Scope()
        scope.load_numpy(state, tfluid.CPUPlace())
        tfluid.io.save_inference_model(
            d, ['x'], [ttest.global_block().var(prob)],
            tfluid.Executor(tfluid.CPUPlace()), main_program=ttest,
            scope=scope)
    got = tinference.Predictor(d, place=tfluid.CPUPlace()).run(req)[0]
    want = np.asarray(jinference.Predictor(d).run(req)[0])
    assert got.shape == (3, 5)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # test mode: the answers come from the saved running stats, which are
    # not the startup's 0 and 1
    stats = _stats(state)
    assert len(stats) == 8
    assert all(not np.all(state[n] == (0.0 if n.endswith('.w_1') else 1.0))
               for n in stats)


def test_concurrent_serving_leaves_the_running_stats_unchanged(bn_state,
                                                               tmp_path):
    """A served batch-norm net writes its running stats back on every
    request (MeanOut and VarianceOut are the Mean and Variance
    persistables); in test mode they are the same tensors, so concurrent
    requests leave them bitwise as they were."""
    tmain, prob, state, req = bn_state
    test = tmain.clone(for_test=True)
    scope = tfluid.Scope()
    scope.load_numpy(state, tfluid.CPUPlace())
    d = str(tmp_path)
    tfluid.io.save_inference_model(
        d, ['x'], [test.global_block().var(prob)],
        tfluid.Executor(tfluid.CPUPlace()), main_program=test, scope=scope)
    pred = tinference.Predictor(d, place=tfluid.CPUPlace())
    stats = _stats(state)
    before = pred._scope.to_numpy(stats)
    r = np.random.RandomState(8)
    reqs = [{'x': r.randn(1 + i % 3, 8, 16, 16).astype('float32')}
            for i in range(12)]
    engine = tserving.ServingEngine(pred, tserving.ServingConfig(
        max_batch_size=8, max_queue_delay_ms=5.0))
    try:
        engine.warmup()
        with concurrent.futures.ThreadPoolExecutor(6) as pool:
            futs = list(pool.map(engine.submit, reqs))
        answers = [f.result(timeout=120)[0] for f in futs]
    finally:
        engine.shutdown()
    after = pred._scope.to_numpy(stats)
    for n in stats:
        assert np.array_equal(after[n], before[n]), n
        np.testing.assert_array_equal(after[n], state[n])
    for q, a in zip(reqs, answers):
        np.testing.assert_allclose(a, pred.run(q)[0], rtol=1e-5, atol=1e-6)


# -- readers and the DataFeeder --------------------------------------------

def _first(reader, n):
    out = []
    for i, s in enumerate(reader()):
        if i == n:
            break
        out.append(s)
    return out


@pytest.mark.parametrize('name', ['uci_housing.train', 'uci_housing.test',
                                  'mnist.train', 'mnist.test',
                                  'cifar.train10', 'cifar.test10',
                                  'cifar.train100', 'flowers.test'])
def test_readers_yield_the_jax_samples(name):
    mod, fn = name.split('.')
    kw = {'use_xmap': False} if mod == 'flowers' else {}
    got = _first(getattr(getattr(tpaddle.dataset, mod), fn)(**kw), 5)
    want = _first(getattr(getattr(jpaddle.dataset, mod), fn)(**kw), 5)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    if mod == 'flowers':
        assert got[0][0].shape == (3 * 224 * 224,)


def test_flowers_train_reader_through_xmap():
    """The train mapper's random crop and flip through 4 threads: the
    same multiset of labels as the raw reader, CHW images of 224."""
    samples = list(tpaddle.dataset.flowers.train()())
    assert len(samples) == 512
    assert all(s[0].shape == (3 * 224 * 224,) and s[0].dtype == np.float32
               for s in samples[:8])
    raw = [lbl for _, lbl in
           tpaddle.dataset.flowers._raw_reader('train', 512)()]
    assert sorted(s[1] for s in samples) == sorted(raw)


def test_reader_decorators_match_the_jax_ones():
    def source():
        return iter(range(23))

    def square(v):
        return v * v

    for pkg in (tpaddle, jpaddle):
        random.seed(3)
        got = list(pkg.reader.shuffle(source, 7)())
        if pkg is tpaddle:
            port = got
    assert port == got and sorted(port) == list(range(23))
    for make in (lambda r: r.map_readers(square, source),
                 lambda r: r.buffered(source, 4),
                 lambda r: r.firstn(source, 5),
                 lambda r: r.xmap_readers(square, source, 3, 4, order=True)):
        assert list(make(tpaddle.reader)()) == list(make(jpaddle.reader)())
    unordered = list(tpaddle.reader.xmap_readers(square, source, 3, 4)())
    assert sorted(unordered) == [v * v for v in range(23)]


def test_xmap_forwards_a_mapper_error():
    def source():
        return iter(range(10))

    def bad(v):
        if v == 6:
            raise ValueError('bad sample')
        return v

    with pytest.raises(ValueError, match='bad sample'):
        list(tpaddle.reader.xmap_readers(bad, source, 2, 4)())


@pytest.mark.parametrize('model', ['fit', 'mnist'])
def test_data_feeder_matches_the_jax_one(model):
    outs = []
    for pkg in (JAX, PORT):
        paddle, fluid = pkg[0], pkg[1]
        main = _build(pkg, model)[0]
        blk = main.global_block()
        names = ['x', 'y'] if model == 'fit' else ['pixel', 'label']
        reader = paddle.dataset.uci_housing.test() if model == 'fit' \
            else paddle.dataset.mnist.test()
        rows = _first(reader, 6)
        outs.append(fluid.DataFeeder([blk.var(n) for n in names],
                                     fluid.CPUPlace()).feed(rows))
    j, t = outs
    assert sorted(j) == sorted(t)
    for n in j:
        assert t[n].dtype == np.asarray(j[n]).dtype, n
        np.testing.assert_array_equal(t[n], np.asarray(j[n]))
    if model == 'mnist':
        assert t['pixel'].shape == (6, 1, 28, 28)
        assert t['label'].shape == (6, 1)


def test_data_feeder_refuses_a_sequence_slot():
    """A sequence slot (lod_level 1) becomes a padded SeqValue; a sample
    whose sequence slot holds no sequence is refused."""
    main = tframework.Program()
    with tframework.program_guard(main, tframework.Program()):
        words = tfluid.layers.data(name='w', shape=[1], dtype='int64',
                                   lod_level=1)
    feeder = tfluid.DataFeeder([words], tfluid.CPUPlace())
    seq = feeder.feed([([1, 2, 3],), ([4],)])['w']
    assert seq.data.shape == (2, 8, 1) and seq.lengths.tolist() == [3, 1]
    with pytest.raises(TypeError):
        feeder.feed([(5,)])
