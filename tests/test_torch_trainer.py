"""The port's high-level Trainer and Inferencer (fluid/trainer.py,
inferencer.py) and its dense checkpoints (fluid/io.py save_checkpoint,
list_checkpoint_serials, load_checkpoint) against the JAX package's, on
the CPU, at small sizes: the linear net of tests/test_trainer.py and the
conv MNIST net of tests/test_book_high_level_api.py (num_filters 8).

  * from the same weights (a JAX Trainer.save_params dir read by both
    packages' Trainer(param_path=)) and the same seeded reader: per-step
    losses within 1e-5 over 2 epochs, the same event sequence, test()
    equal, and an Inferencer on the trained params equal to the JAX one;
  * a checkpoint serial written by one package's Trainer (crashed at
    epoch 1, step 3) resumes in the other's at (1, 4) with every
    persistable bitwise equal, in both directions; the files are the JAX
    format (meta keys, CRC32);
  * resume edge cases: a torn newest serial (truncated, one flipped byte,
    no meta) falls back to the one before with a warning, as the JAX
    Trainer does; request_preemption and a SIGTERM on the main thread
    flush an emergency serial (meta preempted: true) and the next Trainer
    resumes at the next step; _clean_checkpoint spares a stray file;
  * bundle_steps=4 against 1 (a short last batch, the periodic gate's
    saves equal to the JAX bundled loop's), sync='async' (the window's
    handles drain, a handler exception mid-window releases them),
    double_buffer on and off bitwise;
  * Trainer() and Inferencer() without a place raise here, where there is
    no card; the arguments of later slices raise NotImplementedError;
    the constructor's checks raise the JAX messages.
"""
import gc
import json
import os
import signal
import warnings

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (conftest pins it to the CPU)

import paddle_tpu as jpaddle
import paddle_tpu.fluid as jfluid

import paddle_tpu_torch as tpaddle
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import obs as tobs

PKG = {'jax': (jpaddle, jfluid), 'port': (tpaddle, tfluid)}
LOSS_TOL = 1e-5
_W = np.array([[1.5], [-2.0], [0.5], [3.0]], 'float32')


def _linear_train_func(fluid):
    def train_func():
        x = fluid.layers.data(name='x', shape=[4], dtype='float32')
        y = fluid.layers.data(name='y', shape=[1], dtype='float32')
        pred = fluid.layers.fc(input=x, size=1, act=None)
        return fluid.layers.mean(
            fluid.layers.square_error_cost(input=pred, label=y))
    return train_func


def _linear_infer_func(fluid):
    def infer_func():
        x = fluid.layers.data(name='x', shape=[4], dtype='float32')
        return fluid.layers.fc(input=x, size=1, act=None)
    return infer_func


def _linear_reader(n=64, batch=8, seed=0, last=None):
    """n // batch batches of `batch` rows; `last` rows more as a short
    last batch."""
    def r():
        rng = np.random.RandomState(seed)
        sizes = [batch] * (n // batch) + ([last] if last else [])
        for b in sizes:
            xs = rng.rand(b, 4).astype('float32')
            ys = xs @ _W
            yield [(xs[i], ys[i]) for i in range(b)]
    return r


def _conv_net(fluid):
    img = fluid.layers.data(name='img', shape=[1, 28, 28], dtype='float32')
    predict = fluid.nets.simple_img_conv_pool(
        input=img, filter_size=5, num_filters=8, pool_size=2, pool_stride=2,
        act='relu')
    return fluid.layers.fc(input=predict, size=10, act='softmax')


def _conv_train_func(fluid):
    def train_func():
        predict = _conv_net(fluid)
        label = fluid.layers.data(name='label', shape=[1], dtype='int64')
        cost = fluid.layers.cross_entropy(input=predict, label=label)
        avg_cost = fluid.layers.mean(cost)
        acc = fluid.layers.accuracy(input=predict, label=label)
        return [avg_cost, acc]
    return train_func


def _conv_reader(seed=0, batch=16, steps=3):
    """`steps` batches of synthetic MNIST samples, numpy-seeded."""
    def r():
        rng = np.random.RandomState(seed)
        for _ in range(steps):
            imgs = rng.rand(batch, 1, 28, 28).astype('float32')
            labels = rng.randint(0, 10, size=(batch, 1)).astype('int64')
            yield [(imgs[i], labels[i]) for i in range(batch)]
    return r


MODELS = {
    'linear': dict(train=_linear_train_func, infer=_linear_infer_func,
                   reader=_linear_reader, test_reader=lambda: _linear_reader(
                       n=24, seed=1),
                   feed_order=['x', 'y'],
                   opt=lambda fluid: fluid.optimizer.SGD(learning_rate=0.1)),
    'conv': dict(train=_conv_train_func, infer=lambda fluid: (
        lambda: _conv_net(fluid)), reader=_conv_reader,
        test_reader=lambda: _conv_reader(seed=1, steps=2),
        feed_order=['img', 'label'],
        opt=lambda fluid: fluid.optimizer.Adam(learning_rate=0.005)),
}


def _trainer(pkg, model='linear', **kw):
    _, fluid = PKG[pkg]
    m = MODELS[model]
    return fluid.Trainer(train_func=m['train'](fluid),
                         optimizer_func=lambda: m['opt'](fluid),
                         place=fluid.CPUPlace(), **kw)


def _recorder(pkg, sink, losses=None, then=None):
    """An event handler appending (type, epoch, step) to sink and, at each
    EndStepEvent with metrics, the metrics as floats to losses."""
    _, fluid = PKG[pkg]

    def handler(ev):
        sink.append((type(ev).__name__, getattr(ev, 'epoch', None),
                     getattr(ev, 'step', None)))
        if isinstance(ev, fluid.EndStepEvent) and losses is not None \
                and ev.metrics:
            losses.append([float(np.asarray(m).reshape(-1)[0])
                           for m in ev.metrics])
        if then is not None:
            then(ev)
    return handler


def _state(trainer):
    """Every persistable of the trainer's program, as numpy."""
    names = [v.name for v in trainer.train_program.list_vars()
             if v.persistable and v.name in trainer.scope.vars]
    return {n: np.array(trainer.scope.vars[n]) for n in names}


@pytest.fixture(scope='module')
def start_params(tmp_path_factory):
    """{model: a JAX Trainer.save_params dir of its startup weights}."""
    out = {}
    for model in MODELS:
        d = str(tmp_path_factory.mktemp('params_' + model))
        _trainer('jax', model).save_params(d)
        out[model] = d
    return out


@pytest.mark.parametrize('model', ['linear', 'conv'])
def test_losses_events_and_test_match_jax(model, start_params, tmp_path):
    m = MODELS[model]
    runs = {}
    for pkg in ('jax', 'port'):
        t = _trainer(pkg, model, param_path=start_params[model])
        events, losses = [], []
        t.train(num_epochs=2, event_handler=_recorder(pkg, events, losses),
                reader=m['reader'](), feed_order=m['feed_order'])
        test = t.test(m['test_reader'](), feed_order=m['feed_order'])
        out = str(tmp_path / pkg)
        t.save_params(out)
        runs[pkg] = (events, np.array(losses), test, out)
    (je, jl, jt, jdir), (te, tl, tt, tdir) = runs['jax'], runs['port']
    assert te == je
    assert len(tl) == 2 * (8 if model == 'linear' else 3)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_TOL, atol=LOSS_TOL)
    assert abs(jl[-1][0] - jl[0][0]) > 1e-3     # the steps did move
    np.testing.assert_allclose(tt, jt, rtol=LOSS_TOL, atol=LOSS_TOL)

    # the Inferencer on each package's trained params answers like JAX's
    r = np.random.RandomState(3)
    feed = ({'x': r.rand(5, 4).astype('float32')} if model == 'linear'
            else {'img': r.rand(4, 1, 28, 28).astype('float32')})
    jinf = jfluid.Inferencer(infer_func=m['infer'](jfluid), param_path=jdir,
                             place=jfluid.CPUPlace())
    tinf = tfluid.Inferencer(infer_func=m['infer'](tfluid), param_path=tdir,
                             place=tfluid.CPUPlace())
    jout = np.asarray(jinf.infer(feed)[0])
    tout = np.asarray(tinf.infer(feed)[0])
    assert tout.shape == jout.shape
    np.testing.assert_allclose(tout, jout, rtol=1e-5, atol=1e-5)
    # the same params dir through both Inferencers: equal within 1e-5
    cross = np.asarray(tfluid.Inferencer(
        infer_func=m['infer'](tfluid), param_path=jdir,
        place=tfluid.CPUPlace()).infer(feed)[0])
    np.testing.assert_allclose(cross, jout, rtol=1e-5, atol=1e-5)


def test_inferencer_parallel_warns_like_jax(start_params):
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter('always')
        tfluid.Inferencer(infer_func=_linear_infer_func(tfluid),
                          param_path=start_params['linear'],
                          place=tfluid.CPUPlace(), parallel=True)
    assert any(issubclass(w.category, DeprecationWarning)
               and 'parallel=True' in str(w.message) for w in rec)
    with pytest.raises(ValueError, match='map of'):
        tfluid.Inferencer(infer_func=_linear_infer_func(tfluid),
                          param_path=start_params['linear'],
                          place=tfluid.CPUPlace()).infer([1, 2])


class _Crash(Exception):
    pass


def _crash_at(pkg, ckpt, at, model='linear', **kw):
    """Train with a checkpoint every step until EndStepEvent `at` raises
    (a hard kill: no cleanup). Returns (trainer, events)."""
    _, fluid = PKG[pkg]
    cfg = fluid.CheckpointConfig(checkpoint_dir=ckpt, max_num_checkpoints=3,
                                 epoch_interval=1, step_interval=1)
    t = _trainer(pkg, model, checkpoint_config=cfg, **kw)
    events = []

    def then(ev):
        if isinstance(ev, fluid.EndStepEvent) and (ev.epoch, ev.step) == at:
            raise _Crash()

    with pytest.raises(_Crash):
        t.train(num_epochs=3, event_handler=_recorder(pkg, events,
                                                      then=then),
                reader=MODELS[model]['reader'](),
                feed_order=MODELS[model]['feed_order'])
    return t, events


def _resume(pkg, ckpt, model='linear', **kw):
    """A fresh Trainer over `ckpt`; returns (trainer, its state at resume,
    the events of its train())."""
    _, fluid = PKG[pkg]
    cfg = fluid.CheckpointConfig(checkpoint_dir=ckpt, max_num_checkpoints=3,
                                 epoch_interval=1, step_interval=1)
    t = _trainer(pkg, model, checkpoint_config=cfg, **kw)
    state = _state(t)
    events = []
    t.train(num_epochs=3, event_handler=_recorder(pkg, events),
            reader=MODELS[model]['reader'](),
            feed_order=MODELS[model]['feed_order'])
    return t, state, events


@pytest.mark.parametrize('writer,reader', [('jax', 'port'), ('port', 'jax')])
@pytest.mark.parametrize('model', ['linear', 'conv'])
def test_a_serial_resumes_across_packages(writer, reader, model, tmp_path):
    ckpt = str(tmp_path / 'ckpt')
    at = (1, 3) if model == 'linear' else (1, 1)
    t1, _ = _crash_at(writer, ckpt, at, model)
    crashed = _state(t1)
    serials = PKG[writer][1].io.list_checkpoint_serials(ckpt)
    assert PKG[reader][1].io.list_checkpoint_serials(ckpt) == serials
    with open(os.path.join(ckpt, 'checkpoint_%d' % serials[-1],
                           'meta.json')) as f:
        meta = json.load(f)
    assert sorted(meta) == ['params_bytes', 'params_crc32', 'params_file',
                            'step', 'trainer_args', 'trainer_id']
    assert meta['trainer_args'] == {'epoch_id': at[0], 'step_id': at[1]}

    t2, resumed, events = _resume(reader, ckpt, model)
    assert sorted(resumed) == sorted(crashed)
    for n in crashed:
        np.testing.assert_array_equal(resumed[n], crashed[n], err_msg=n)
    steps = [(e, s) for k, e, s in events if k == 'BeginStepEvent']
    assert steps[0] == (at[0], at[1] + 1)
    # a clean finish removes the serials
    assert PKG[reader][1].io.list_checkpoint_serials(ckpt) == []


def test_checkpoint_io_functions_match_jax(tmp_path):
    """save_checkpoint writes the JAX files: the same npz names and
    arrays, the same meta, a CRC32 equal to the JAX one; load_checkpoint
    of either package reads the other's serial."""
    from paddle_tpu.utils.checkpoint import _crc32_file as jcrc
    t = _trainer('port')
    for pkg in ('jax', 'port'):
        fluid = PKG[pkg][1]
        d = str(tmp_path / pkg)
        with tfluid.scope_guard(t.scope):
            if pkg == 'port':
                tfluid.io.save_checkpoint(
                    t.exe, d, main_program=t.train_program, step=7,
                    trainer_args={'epoch_id': 2, 'step_id': 5},
                    max_num_checkpoints=2)
            else:
                jscope = jfluid.Scope()
                for n, a in _state(t).items():
                    jscope.vars[n] = a
                with jfluid.scope_guard(jscope):
                    jt = _trainer('jax')
                    jfluid.io.save_checkpoint(
                        jt.exe, d, main_program=jt.train_program, step=7,
                        trainer_args={'epoch_id': 2, 'step_id': 5},
                        max_num_checkpoints=2)
    metas = {}
    for pkg in ('jax', 'port'):
        serial = os.path.join(str(tmp_path / pkg), 'checkpoint_7')
        with open(os.path.join(serial, 'meta.json')) as f:
            metas[pkg] = json.load(f)
        path = os.path.join(serial, '__params__.npz')
        assert metas[pkg]['params_crc32'] == jcrc(path) \
            == tfluid.io._crc32_file(path)
    with np.load(str(tmp_path / 'jax' / 'checkpoint_7' / '__params__.npz')) \
            as a, np.load(str(tmp_path / 'port' / 'checkpoint_7'
                              / '__params__.npz')) as b:
        assert sorted(a.files) == sorted(b.files)
        for n in a.files:
            np.testing.assert_array_equal(a[n], b[n])
    for key in ('step', 'trainer_id', 'trainer_args', 'params_file'):
        assert metas['port'][key] == metas['jax'][key]
    # each package reads the other's serial
    for writer, fluid, who in (('jax', tfluid, 'port'),
                               ('port', jfluid, 'jax')):
        tr = _trainer(who)
        with PKG[who][1].scope_guard(tr.scope):
            meta = fluid.io.load_checkpoint(
                tr.exe, str(tmp_path / writer),
                main_program=tr.train_program)
        assert meta['trainer_args'] == {'epoch_id': 2, 'step_id': 5}
        for n, a in _state(t).items():
            np.testing.assert_array_equal(np.array(tr.scope.vars[n]), a)
    assert tfluid.io.list_checkpoint_serials(str(tmp_path / 'none')) == []
    with pytest.raises(RuntimeError, match='no checkpoints'):
        tfluid.io.load_checkpoint(t.exe, str(tmp_path / 'none'))


def _damage(serial_dir, how):
    path = os.path.join(serial_dir, '__params__.npz')
    if how == 'truncated':
        with open(path, 'r+b') as f:
            f.truncate(os.path.getsize(path) // 2)
    elif how == 'flipped':
        with open(path, 'r+b') as f:
            f.seek(os.path.getsize(path) // 2)
            b = f.read(1)
            f.seek(-1, os.SEEK_CUR)
            f.write(bytes([b[0] ^ 0x01]))
    else:
        os.remove(os.path.join(serial_dir, 'meta.json'))


@pytest.mark.parametrize('how', ['truncated', 'flipped', 'no_meta'])
def test_a_torn_newest_serial_falls_back_to_the_one_before(how, tmp_path):
    """Both packages skip the torn serial with a warning and resume at
    the serial before it: the same step, the same weights."""
    ckpt = str(tmp_path / 'ckpt')
    _crash_at('port', ckpt, (0, 5))
    serials = tfluid.io.list_checkpoint_serials(ckpt)
    assert len(serials) == 3
    _damage(os.path.join(ckpt, 'checkpoint_%d' % serials[-1]), how)
    got = {}
    for pkg in ('jax', 'port'):
        fluid = PKG[pkg][1]
        cfg = fluid.CheckpointConfig(checkpoint_dir=ckpt, step_interval=1)
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter('always')
            t = _trainer(pkg, checkpoint_config=cfg)
        msgs = [str(w.message) for w in rec
                if issubclass(w.category, RuntimeWarning)]
        assert any('serial %d' % serials[-1] in m and 'falling back' in m
                   for m in msgs), msgs
        assert (cfg.epoch_id, cfg.step_id) == (0, 4)
        got[pkg] = _state(t)
    for n in got['jax']:
        np.testing.assert_array_equal(got['port'][n], got['jax'][n])


def test_load_checkpoint_verifies_before_loading(tmp_path):
    ckpt = str(tmp_path / 'ckpt')
    t, _ = _crash_at('port', ckpt, (0, 2))
    before = _state(t)
    serial = tfluid.io.list_checkpoint_serials(ckpt)[-1]
    _damage(os.path.join(ckpt, 'checkpoint_%d' % serial), 'flipped')
    t.scope.vars = type(t.scope.vars)(
        (n, v + 1 if n in before else v) for n, v in t.scope.vars.items())
    moved = _state(t)
    with tfluid.scope_guard(t.scope):
        with pytest.raises(RuntimeError, match='CRC32'):
            tfluid.io.load_checkpoint(t.exe, ckpt,
                                      main_program=t.train_program)
    after = _state(t)
    for n in moved:   # nothing reached the scope
        np.testing.assert_array_equal(after[n], moved[n])


@pytest.mark.parametrize('how', ['request', 'sigterm', 'reader_blocks'])
def test_preemption_flushes_and_the_next_trainer_resumes(how, tmp_path):
    ckpt = str(tmp_path / 'ckpt')
    cfg = tfluid.CheckpointConfig(checkpoint_dir=ckpt, step_interval=100)
    t = _trainer('port', checkpoint_config=cfg)
    at = (1, 2)
    base = _linear_reader()

    def then(ev):
        if isinstance(ev, tfluid.BeginStepEvent) and (ev.epoch, ev.step) \
                == at:
            if how == 'request':
                t.request_preemption()
            elif how == 'sigterm':
                os.kill(os.getpid(), signal.SIGTERM)

    def reader():
        for i, b in enumerate(base()):
            if how == 'reader_blocks' and i == at[1] and t._steps_run > 8:
                t.request_preemption()   # lands while the batch is read
            yield b

    prev = signal.getsignal(signal.SIGTERM)
    events = []
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter('always')
        t.train(num_epochs=3, event_handler=_recorder('port', events,
                                                      then=then),
                reader=reader, feed_order=['x', 'y'])
    assert t.preempted
    assert signal.getsignal(signal.SIGTERM) == prev
    assert any('emergency checkpoint flushed' in str(w.message)
               for w in rec)
    steps = [(e, s) for k, e, s in events if k == 'BeginStepEvent']
    done = at if how != 'reader_blocks' else (at[0], at[1] - 1)
    assert steps[-1] == done
    serials = tfluid.io.list_checkpoint_serials(ckpt)
    with open(os.path.join(ckpt, 'checkpoint_%d' % serials[-1],
                           'meta.json')) as f:
        meta = json.load(f)
    assert meta['trainer_args'] == {'epoch_id': done[0],
                                    'step_id': done[1], 'preempted': True}
    state = _state(t)
    t2, resumed, events2 = _resume('port', ckpt)
    for n in state:
        np.testing.assert_array_equal(resumed[n], state[n])
    steps2 = [(e, s) for k, e, s in events2 if k == 'BeginStepEvent']
    assert steps2[0] == (done[0], done[1] + 1)
    assert not t2.preempted


def test_preemption_without_a_checkpoint_config_warns(tmp_path):
    t = _trainer('port')
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter('always')
        t.train(num_epochs=2, event_handler=lambda ev: t.request_preemption()
                if isinstance(ev, tfluid.BeginStepEvent) else None,
                reader=_linear_reader(), feed_order=['x', 'y'])
    assert t.preempted
    assert any('SKIPPED' in str(w.message) for w in rec)


def test_clean_checkpoint_spares_what_it_did_not_write(tmp_path):
    ckpt = tmp_path / 'ckpt'
    ckpt.mkdir()
    (ckpt / 'notes.txt').write_text('keep me')
    (ckpt / 'checkpoint_x').mkdir()
    (ckpt / 'sharded_3').mkdir()
    cfg = tfluid.CheckpointConfig(checkpoint_dir=str(ckpt), step_interval=2)
    t = _trainer('port', checkpoint_config=cfg)
    seen = []

    def then(ev):
        if isinstance(ev, tfluid.EndStepEvent):
            seen.append(tfluid.io.list_checkpoint_serials(str(ckpt)))

    t.train(num_epochs=1, event_handler=_recorder('port', [], then=then),
            reader=_linear_reader(), feed_order=['x', 'y'])
    assert max(len(s) for s in seen) == 3     # max_num_checkpoints
    assert sorted(os.listdir(str(ckpt))) == ['checkpoint_x', 'notes.txt',
                                             'sharded_3']


def _w(trainer):
    return {n: np.array(v) for n, v in trainer.scope.vars.items()
            if n.endswith('.w_0') or n.endswith('.b_0')}


def test_bundle_4_matches_unbundled_with_a_short_last_batch():
    runs = {}
    for k in (1, 4):
        t = _trainer('port', bundle_steps=k)
        events, losses = [], []
        t.train(num_epochs=2, event_handler=_recorder('port', events, losses),
                reader=_linear_reader(n=40, batch=4, last=3),
                feed_order=['x', 'y'])
        runs[k] = (events, np.array(losses), _w(t))
    # a bundle fires its K BeginStepEvents as it buffers and its K
    # EndStepEvents after the one dispatch: each kind in the same order
    for kind in ('BeginStepEvent', 'EndStepEvent', 'EndEpochEvent'):
        assert [e for e in runs[4][0] if e[0] == kind] \
            == [e for e in runs[1][0] if e[0] == kind]
    assert len(runs[4][1]) == 2 * 11
    np.testing.assert_allclose(runs[4][1], runs[1][1], rtol=1e-6, atol=0)
    for n, a in runs[1][2].items():
        np.testing.assert_allclose(runs[4][2][n], a, rtol=1e-6, atol=1e-7)


def test_bundled_periodic_gate_saves_what_jax_saves(monkeypatch, tmp_path):
    """K=8 over 11 steps an epoch (the last one short) with
    step_interval=10: the bundles [0..7], [8, 9] and [10] (the short
    batch's signature flushes [8, 9]) end on no multiple but 10, step 0
    crosses inside the first; the port saves at the steps the JAX loop
    saves at, each bundle's last."""
    saved = {'jax': [], 'port': []}
    for pkg in ('jax', 'port'):
        fluid = PKG[pkg][1]
        real = fluid.io.save_checkpoint

        def spy(*a, _real=real, _pkg=pkg, **kw):
            saved[_pkg].append(dict(kw['trainer_args']))
            return _real(*a, **kw)
        monkeypatch.setattr(fluid.io, 'save_checkpoint', spy)
        cfg = fluid.CheckpointConfig(
            checkpoint_dir=str(tmp_path / pkg), step_interval=10)
        t = _trainer(pkg, bundle_steps=8, checkpoint_config=cfg)
        t.train(num_epochs=2, event_handler=lambda ev: None,
                reader=_linear_reader(n=80, batch=8, last=3),
                feed_order=['x', 'y'])
    assert saved['port'] == saved['jax']
    assert saved['port'] == [{'epoch_id': e, 'step_id': s}
                             for e in (0, 1) for s in (7, 10)]


def test_async_window_matches_blocking_and_drains():
    """The handler keeps its metrics unread: at most async_window steps
    stay in flight, the window drains at the end, and the values read
    afterwards are the blocking run's."""
    gauge = tobs.gauge('executor.inflight')
    runs = {}
    for kw in ({}, dict(sync='async', async_window=2)):
        t = _trainer('port', **kw)
        held, inflight = [], []

        def handler(ev):
            if isinstance(ev, tfluid.EndStepEvent):
                held.append(ev.metrics)
                inflight.append(gauge.value or 0)

        t.train(num_epochs=2, event_handler=handler,
                reader=_linear_reader(), feed_order=['x', 'y'])
        losses = [float(np.asarray(m[0]).reshape(-1)[0]) for m in held]
        runs[bool(kw)] = (losses, _w(t), max(inflight))
    np.testing.assert_array_equal(runs[True][0], runs[False][0])
    for n, a in runs[False][1].items():
        np.testing.assert_array_equal(runs[True][1][n], a)
    assert runs[True][2] == 2 and runs[False][2] == 0
    gc.collect()
    assert (gauge.value or 0) == 0


def test_async_handler_exception_mid_window_releases_the_handles():
    held = []

    def handler(ev):
        if isinstance(ev, tfluid.EndStepEvent):
            held.append(ev.metrics)
            if ev.step == 3:
                raise RuntimeError('handler crashed mid-window')

    t = _trainer('port', sync='async', async_window=2)
    with pytest.raises(RuntimeError, match='mid-window'):
        t.train(num_epochs=1, event_handler=handler,
                reader=_linear_reader(), feed_order=['x', 'y'])
    del held
    gc.collect()
    assert (tobs.gauge('executor.inflight').value or 0) == 0


@pytest.mark.parametrize('bundle', [1, 4])
def test_double_buffer_is_bitwise_the_inline_feed(bundle):
    runs = {}
    for db in (False, True):
        t = _trainer('port', 'conv', double_buffer=db, bundle_steps=bundle)
        losses = []
        t.train(num_epochs=2, event_handler=_recorder('port', [], losses),
                reader=_conv_reader(steps=5), feed_order=['img', 'label'])
        runs[db] = (losses, _state(t), t.batches_fed, t.input_stage_s)
    assert runs[True][0] == runs[False][0]
    for n, a in runs[False][1].items():
        np.testing.assert_array_equal(runs[True][1][n], a, err_msg=n)
    assert runs[True][2] == runs[False][2] == 10
    assert runs[True][3] >= 0.0 and runs[False][3] > 0.0


def test_place_feed_is_what_run_takes():
    """Executor._place_feed, the prefetch worker's stage: on the CPU the
    feed coerced as run() coerces it, and run() takes it as a feed."""
    t = _trainer('port')
    feeder = tfluid.DataFeeder(feed_list=['x', 'y'], place=tfluid.CPUPlace(),
                               program=t.train_program)
    fed = feeder.feed(next(_linear_reader()()))
    staged = t.exe._place_feed(t.train_program, fed)
    assert all(isinstance(v, torch.Tensor) and v.dtype == torch.float32
               for v in staged.values())
    for n in fed:
        np.testing.assert_array_equal(staged[n].numpy(), fed[n])
    with tfluid.scope_guard(t.scope):
        a = t.exe.run(t.train_program, feed=staged,
                      fetch_list=t.train_func_outputs)
    assert np.isfinite(a[0]).all()


def test_trainer_without_a_place_runs_on_the_card_and_raises_here(
        start_params):
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present: the no-card contract does not '
                    'apply')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        tfluid.Trainer(train_func=_linear_train_func(tfluid),
                       optimizer_func=lambda: tfluid.optimizer.SGD(0.1))
    with pytest.raises(RuntimeError, match='no CUDA device'):
        tfluid.Inferencer(infer_func=_linear_infer_func(tfluid),
                          param_path=start_params['linear'])
    with pytest.raises(RuntimeError, match='no CUDA device'):
        tfluid.trainer.check_and_get_place(None)
    cpu = tfluid.CPUPlace()
    assert tfluid.trainer.check_and_get_place(cpu) is cpu


@pytest.mark.parametrize('kw', [dict(parallel=True),
                                dict(transpiler_fn=lambda p: None),
                                dict(heartbeat=object())])
def test_arguments_of_later_slices_raise(kw):
    """heartbeat waits for the later part of "Parallel" and raises naming
    it; parallel=True and transpiler_fn are ported (data parallelism) and
    build as the JAX Trainer does (their training runs on gloo ranks in
    tests/test_torch_parallel.py), and both refuse to compose as in JAX."""
    if 'heartbeat' in kw:
        with pytest.raises(NotImplementedError, match='Parallel'):
            _trainer('port', **kw)
        return
    t = _trainer('port', **kw)
    assert t.parallel is bool(kw.get('parallel'))
    with pytest.raises(ValueError) as je:
        _trainer('jax', parallel=True, transpiler_fn=lambda p: None)
    with pytest.raises(ValueError) as te:
        _trainer('port', parallel=True, transpiler_fn=lambda p: None)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize('kw', [dict(bundle_steps=0), dict(sync='never'),
                                dict(parallel=True, bundle_steps=4),
                                dict(bundle_steps=4, sync='async')])
def test_constructor_checks_raise_the_jax_messages(kw):
    with pytest.raises(ValueError) as je:
        _trainer('jax', **kw)
    with pytest.raises(ValueError) as te:
        _trainer('port', **kw)
    assert str(te.value) == str(je.value)


def test_build_feed_var_list_like_jax():
    for pkg in ('jax', 'port'):
        t = _trainer(pkg)
        fluid = PKG[pkg][1]
        build = fluid.trainer.build_feed_var_list
        assert [v.name for v in build(t.train_program)] == ['x', 'y']
        assert [v.name for v in build(t.train_program, {'y': 0, 'x': 1})] \
            == ['y', 'x']
        with pytest.raises(ValueError):
            build(t.train_program, {'y': 0, 'x': 2})
        with pytest.raises(TypeError):
            build(t.train_program, 'x')
        with pytest.raises(TypeError):
            build(object())


def test_stop_ends_training_and_cleans_the_serials(tmp_path):
    cfg = tfluid.CheckpointConfig(checkpoint_dir=str(tmp_path),
                                  step_interval=1)
    t = _trainer('port', checkpoint_config=cfg)
    seen = []

    def handler(ev):
        if isinstance(ev, tfluid.EndStepEvent):
            seen.append(ev.step)
            if len(seen) >= 3:
                t.stop()

    t.train(num_epochs=10, event_handler=handler, reader=_linear_reader(),
            feed_order=['x', 'y'])
    assert seen == [0, 1, 2]
    assert tfluid.io.list_checkpoint_serials(str(tmp_path)) == []


def test_fluid_exports_the_high_level_api():
    for name in ('Trainer', 'CheckpointConfig', 'Inferencer',
                 'BeginEpochEvent', 'EndEpochEvent', 'BeginStepEvent',
                 'EndStepEvent', 'metrics', 'average', 'evaluator'):
        assert hasattr(tfluid, name), name
    for name in jfluid.trainer.__all__ + jfluid.inferencer.__all__:
        assert name in tfluid.__all__, name
    ev = tfluid.BeginStepEvent(1, 2)
    assert (ev.epoch, ev.step, ev.fetch_metrics) == (1, 2, True)
    cfg = tfluid.CheckpointConfig(async_save=True, commit_timeout=5,
                                  wallclock_interval_s=3)
    jcfg = jfluid.CheckpointConfig(async_save=True, commit_timeout=5,
                                   wallclock_interval_s=3)
    assert vars(cfg) == vars(jcfg)


def test_install_as_paddle_covers_the_trainer():
    """A book script's `paddle.fluid.Trainer` and `paddle.reader`
    decorators resolve to the port's after install_as_paddle (in a fresh
    interpreter: the alias is process-wide)."""
    import subprocess
    import sys
    code = ('import sys\n'
            'import paddle_tpu_torch\n'
            'paddle_tpu_torch.install_as_paddle()\n'
            'import paddle\n'
            'import paddle.fluid as fluid\n'
            'from paddle.fluid.trainer import Trainer, EndStepEvent\n'
            'from paddle.reader.decorator import shuffle\n'
            'from paddle.reader import pipeline\n'
            'import paddle_tpu_torch.fluid.trainer as t\n'
            'assert fluid.Trainer is Trainer is t.Trainer\n'
            'assert EndStepEvent is t.EndStepEvent\n'
            'assert fluid.Inferencer is paddle_tpu_torch.fluid.Inferencer\n'
            'assert shuffle is paddle_tpu_torch.reader.shuffle\n'
            'assert pipeline.prefetch is '
            'paddle_tpu_torch.reader.pipeline.prefetch\n'
            'assert "jax" not in sys.modules and "paddle_tpu" not in '
            'sys.modules\n'
            'print("ok")\n')
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, '-c', code], cwd=root,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == 'ok', r.stderr


@pytest.mark.parametrize('double_buffer', [False, True])
def test_iter_staged_like_jax(double_buffer):
    """_iter_staged's stream: the resume fast-forward yields (step, None)
    without assembly, the post hook rewrites each assembled batch on the
    thread that assembles it, and the fed values equal the JAX Trainer's."""
    import threading
    got = {}
    for pkg in ('jax', 'port'):
        t = _trainer(pkg, double_buffer=double_buffer)
        fluid = PKG[pkg][1]
        feeder = fluid.DataFeeder(feed_list=['x', 'y'],
                                  place=fluid.CPUPlace(),
                                  program=t.train_program)
        threads = set()

        def post(step_id, fed):
            threads.add(threading.get_ident())
            fed['y'] = np.asarray(fed['y']) * 0 + step_id
            return fed

        out = []
        for step_id, fed in t._iter_staged(_linear_reader(), feeder,
                                           skip_until=2, post=post):
            out.append((step_id, None if fed is None else
                        {n: np.asarray(v) for n, v in fed.items()}))
        assert (threading.get_ident() in threads) != double_buffer
        assert t.batches_fed == 5
        got[pkg] = out
    assert [s for s, _ in got['port']] == list(range(8))
    for (js, jf), (ts, tf) in zip(got['jax'], got['port']):
        assert js == ts and (jf is None) == (tf is None)
        if jf is not None:
            for n in jf:
                np.testing.assert_array_equal(tf[n], jf[n])
