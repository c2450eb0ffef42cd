"""The port's reader layers (fluid/layers/io.py: py_reader, read_file,
open_recordio_file, open_files, shuffle, batch, double_buffer,
random_data_generator, Preprocessor, load) against the JAX package's, on
the CPU, on the same seeded numpy inputs:

  * under one random.seed, open_recordio_file / open_files -> shuffle ->
    batch -> double_buffer yield the same batches in both packages;
  * a file of fluid.recordio_writer reads back through the port's
    open_recordio_file and open_files as its declared feed slots, LoD
    included, where the JAX layers hand its schema header over as slot 0;
  * py_reader's start, next, reset and epochs feed a training loop whose
    losses are the JAX loop's from the same weights;
  * random_data_generator is bitwise under one np.random.seed;
  * a Preprocessor block of deterministic ops (cast, scale, the
    elementwise_sub of a mean parameter, transpose) gives the JAX stream's
    values within 1e-6, and a block that fails leaves both programs as
    they were;
  * load puts a .npy file into the scope, on the scope's device;
  * a small resnet_cifar10 (depth 8) trains 3 steps from a recordio chain
    in both packages, from the JAX startup weights, to the same losses;
  * without a card, Preprocessor() and double_buffer(place=CUDAPlace(0))
    raise (on a card: tests/test_torch_recordio_cuda.py).
"""
import contextlib
import random

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (conftest pins it to the CPU)

import paddle_tpu as jpaddle
import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import recordio_writer as jwriter
from paddle_tpu.models import resnet as jresnet
from paddle_tpu.reader import recordio as jrio

import paddle_tpu_torch as tpaddle
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import recordio_writer as twriter
from paddle_tpu_torch.models import resnet as tresnet
from paddle_tpu_torch.reader import recordio as trio

PKGS = {'jax': (jpaddle, jfluid, jrio, jwriter),
        'port': (tpaddle, tfluid, trio, twriter)}
PREP_TOL = 1e-6
LOSS_TOL = 1e-5


@contextlib.contextmanager
def _programs(fluid):
    """Fresh main and startup programs, names and global scope."""
    main, startup = fluid.Program(), fluid.Program()
    scope = fluid.Scope()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup), \
            fluid.scope_guard(scope):
        yield main, startup, scope


def _samples(n=40, seed=1):
    r = np.random.RandomState(seed)
    return [(r.rand(4).astype('float32'), np.array([i % 3], 'int64'))
            for i in range(n)]


def _flat(batches):
    """Every array of a stream of batches, in order, for a bitwise
    comparison."""
    out = []
    for b in batches:
        for sample in b:
            out.extend(np.asarray(a) for a in sample)
    return out


def _same_arrays(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize('opener', ['open_recordio_file', 'open_files'])
def test_chain_yields_the_jax_batches(tmp_path, opener):
    samples = _samples()
    paths = [str(tmp_path / ('s%d.ptrio' % i)) for i in range(3)]
    for i, p in enumerate(paths):
        trio.write_samples(p, iter(samples[i::3]))
    got = {}
    for name, (_, fluid, _, _) in PKGS.items():
        with _programs(fluid):
            layers = fluid.layers
            if opener == 'open_recordio_file':
                r = layers.open_recordio_file(
                    paths[0], shapes=[[-1, 4], [-1, 1]], lod_levels=[0, 0],
                    dtypes=['float32', 'int64'], pass_num=3)
            else:
                r = layers.open_files(
                    paths, shapes=[[-1, 4], [-1, 1]], lod_levels=[0, 0],
                    dtypes=['float32', 'int64'], pass_num=2)
            r = layers.shuffle(r, buffer_size=7)
            r = layers.batch(r, batch_size=5)
            r = layers.double_buffer(r)
            random.seed(11)
            got[name] = [list(r()), list(r())]
    assert len(got['port'][0]) > 4
    for epoch in (0, 1):
        assert [len(b) for b in got['port'][epoch]] == \
            [len(b) for b in got['jax'][epoch]]
        _same_arrays(_flat(got['port'][epoch]), _flat(got['jax'][epoch]))
    # the shuffle permuted the stream, another way each epoch
    order = [[a.tobytes() for a in _flat(e)[::2]] for e in got['port']]
    unshuffled = [a.tobytes() for a, _ in samples]
    assert order[0] != order[1]
    assert order[0][:len(unshuffled)] != unshuffled


def _feed_file(tmp_path, name, lod_levels):
    """Six batches of 3 (a LoD int64 word slot, or a dense float32 [3]; an
    int64 label) written by the port's recordio_writer; returns the path
    and the batches."""
    r = np.random.RandomState(2)
    lod = lod_levels[0]
    batches = []
    for _ in range(6):
        b = []
        for _ in range(3):
            x = ([int(v) for v in r.randint(0, 40, size=r.randint(1, 6))]
                 if lod else r.randn(3).astype('float32'))
            b.append((x, int(r.randint(0, 2))))
        batches.append(b)
    with _programs(tfluid) as (main, _, _):
        x = tfluid.layers.data(name='x', shape=[1] if lod else [3],
                               dtype='int64' if lod else 'float32',
                               lod_level=lod)
        y = tfluid.layers.data(name='y', shape=[1], dtype='int64')
        feeder = tfluid.DataFeeder([x, y], tfluid.CPUPlace(), program=main)
        path = str(tmp_path / name)
        twriter.convert_reader_to_recordio_file(path, lambda: iter(batches),
                                                feeder)
        want = [feeder.feed(b) for b in batches]
    return path, want


@pytest.mark.parametrize('opener', ['open_recordio_file', 'open_files'])
@pytest.mark.parametrize('lod', [0, 1])
def test_a_recordio_writer_file_reads_back_as_its_feed_slots(tmp_path, lod,
                                                             opener):
    path, want = _feed_file(tmp_path, 'f.rec', [lod, 0])
    shapes = [[-1, 1] if lod else [-1, 3], [-1, 1]]
    dtypes = ['int64' if lod else 'float32', 'int64']
    with _programs(tfluid):
        if opener == 'open_recordio_file':
            r = tfluid.layers.open_recordio_file(
                path, shapes=shapes, lod_levels=[lod, 0], dtypes=dtypes)
        else:
            r = tfluid.layers.open_files(
                [path, path], shapes=shapes, lod_levels=[lod, 0],
                dtypes=dtypes)
        x, y = tfluid.layers.read_file(r)
        got = list(r())
    assert len(got) == len(want) * (1 if opener == 'open_recordio_file'
                                    else 2)
    for slots, feed in zip(got, want * 2):
        assert len(slots) == 2
        if lod:
            lt = tfluid.LoDTensor.from_seq_value(feed['x'])
            assert slots[0].recursive_sequence_lengths() == \
                lt.recursive_sequence_lengths()
            assert slots[0].data.tobytes() == lt.data.tobytes()
        else:
            assert slots[0].tobytes() == feed['x'].tobytes()
        assert slots[1].tobytes() == feed['y'].tobytes()


def test_jax_open_recordio_file_returns_the_schema_as_a_slot_and_the_port_does_not(  # noqa: E501
        tmp_path):
    """The JAX layer reads a file of convert_reader_to_recordio_file
    through read_samples, so every record comes back as three arrays: the
    writer's int64 schema [n_slots, lod levels...] first. The port gives
    the two feed slots."""
    path = str(tmp_path / 'xy.rec')
    batches = [[(np.arange(4, dtype='float32') + i, i) for i in range(3)]]
    shapes, dtypes = [[-1, 4], [-1, 1]], ['float32', 'int64']
    got = {}
    for name, (_, fluid, _, writer) in PKGS.items():
        with _programs(fluid) as (main, _, _):
            x = fluid.layers.data(name='x', shape=[4], dtype='float32')
            y = fluid.layers.data(name='y', shape=[1], dtype='int64')
            feeder = fluid.DataFeeder([x, y], fluid.CPUPlace(), program=main)
            writer.convert_reader_to_recordio_file(
                path, lambda: iter(batches), feeder)
            r = fluid.layers.open_recordio_file(
                path, shapes=shapes, lod_levels=[0, 0], dtypes=dtypes)
            got[name] = list(r())
    jrec, = got['jax']
    assert [(a.dtype.name, a.shape) for a in jrec] == \
        [('int64', (3,)), ('float32', (3, 4)), ('int64', (3, 1))]
    assert jrec[0].tolist() == [2, 0, 0]
    trec, = got['port']
    assert [(a.dtype.name, a.shape) for a in trec] == \
        [('float32', (3, 4)), ('int64', (3, 1))]
    assert trec[0].tobytes() == jrec[1].tobytes()
    assert trec[1].tobytes() == jrec[2].tobytes()


def test_a_write_samples_file_led_by_an_int64_vector_stays_samples(tmp_path):
    """A sample record holds one array a slot, a feed record one more
    (the schema): a sample whose first slot happens to look like a schema
    is still read as a sample."""
    path = str(tmp_path / 's.ptrio')
    samples = [(np.array([2, 0, 0], 'int64'), np.float32(i))
               for i in range(4)]
    trio.write_samples(path, iter(samples))
    with _programs(tfluid):
        r = tfluid.layers.open_recordio_file(
            path, shapes=[[-1, 3], [-1, 1]], lod_levels=[0, 0],
            dtypes=['int64', 'float32'])
        got = list(r())
    assert len(got) == 4 and all(len(s) == 2 for s in got)
    assert [s[0].tolist() for s in got] == [[2, 0, 0]] * 4


def _py_reader_losses(fluid, init=None):
    """The JAX test's py_reader loop (tests/test_io_pipeline.py): an fc
    regression fed through start / next / reset for 4 epochs of 6
    batches. Returns (startup weights, losses, epoch lengths)."""
    with _programs(fluid) as (main, startup, scope):
        reader = fluid.layers.py_reader(capacity=8, shapes=[[-1, 4], [-1, 1]],
                                        dtypes=['float32', 'float32'],
                                        name='train_reader')
        x, y = fluid.layers.read_file(reader)
        pred = fluid.layers.fc(input=x, size=1)
        cost = fluid.layers.mean(
            fluid.layers.square_error_cost(input=pred, label=y))
        fluid.optimizer.Adam(learning_rate=0.1).minimize(cost)
        W = np.array([[1.], [-2.], [3.], [0.5]], 'float32')

        def gen():
            r = np.random.RandomState(0)
            for _ in range(6):
                xs = r.rand(8, 4).astype('float32')
                yield xs, xs @ W

        reader.decorate_paddle_reader(gen)
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        if init is None:
            init = {n: np.array(v, copy=True) for n, v in scope.vars.items()}
        else:
            scope.load_numpy(init, fluid.CPUPlace())
        losses, lengths = [], []
        for epoch in range(4):
            reader.start()
            n = 0
            while True:
                try:
                    xs, ys = reader.next()
                except StopIteration:
                    break
                l, = exe.run(main, feed={x.name: xs, y.name: ys},
                             fetch_list=[cost])
                losses.append(float(np.asarray(l).squeeze()))
                n += 1
            lengths.append(n)
            reader.reset()
    return init, losses, lengths


def test_py_reader_start_next_reset_and_epochs():
    init, jl, jn = _py_reader_losses(jfluid)
    _, tl, tn = _py_reader_losses(tfluid, init)
    assert tn == jn == [6, 6, 6, 6]
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-6)
    assert tl[-1] < tl[0] * 0.25
    with _programs(tfluid):
        r = tfluid.layers.py_reader(capacity=2, shapes=[[-1, 2]],
                                    dtypes=['float32'], name='r')
        r.decorate_batch_generator(lambda: iter([1, 2, 3]))
        r.start()
        assert [r.next(), r.next()] == [1, 2]
        r.reset()
        with pytest.raises(TypeError):
            r.next()
        r.start()
        assert r.next() == 1 and list(r()) == [1, 2, 3]
        with pytest.raises(TypeError):
            tfluid.layers.read_file(lambda: None)


def test_random_data_generator_is_bitwise_under_one_seed():
    got = {}
    for name, (_, fluid, _, _) in PKGS.items():
        with _programs(fluid):
            r = fluid.layers.random_data_generator(
                low=-2.0, high=3.0, shapes=[[8, 3], [8, 1]],
                lod_levels=[0, 0])
            vs = fluid.layers.read_file(r)
            np.random.seed(5)
            it = r()
            got[name] = [next(it) for _ in range(3)]
            assert [v.shape for v in vs] == [(-1, 3), (-1, 1)] or \
                [list(v.shape) for v in vs] == [[-1, 3], [-1, 1]]
    for a, b in zip(got['port'], got['jax']):
        _same_arrays(list(a), list(b))
    assert all((a >= -2.0).all() and (a < 3.0).all()
               for s in got['port'] for a in s)


def _raw_batches():
    r = np.random.RandomState(7)
    return [((r.rand(2, 4, 5, 3) * 255).astype('uint8'),
             r.randint(0, 10, size=(2, 1)).astype('int64'))
            for _ in range(3)]


def _preprocessed(fluid, place=None):
    """The deterministic block over _raw_batches through each package's
    Preprocessor, the mean parameter from its startup program."""
    with _programs(fluid) as (main, startup, _):
        reader = fluid.layers.py_reader(
            capacity=2, shapes=[[-1, 4, 5, 3], [-1, 1]],
            dtypes=['uint8', 'int64'], name='raw')
        reader.decorate_paddle_reader(lambda: iter(_raw_batches()))
        p = (fluid.layers.Preprocessor(reader) if place is None
             else fluid.layers.Preprocessor(reader, place=place))
        with p.block():
            img, label = p.inputs()
            x = fluid.layers.cast(img, 'float32')
            x = fluid.layers.scale(x, scale=1.0 / 255.0, bias=0.25)
            mean = fluid.layers.create_parameter(
                shape=[3], dtype='float32', name='prep_mean',
                default_initializer=fluid.initializer.NumpyArrayInitializer(
                    np.array([0.1, 0.5, 0.3], 'float32')))
            x = fluid.layers.elementwise_sub(x, mean, axis=-1)
            x = fluid.layers.transpose(x, perm=[0, 3, 1, 2])
            p.outputs(x, label)
        assert not [op for op in main.global_block().ops]
        assert 'prep_mean' in main.global_block().vars
        fluid.Executor(fluid.CPUPlace()).run(startup)
        return [list(s) for s in reader()]


def test_preprocessor_agrees_with_jax():
    want = _preprocessed(jfluid)
    got = _preprocessed(tfluid, place=tfluid.CPUPlace())
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g[0].shape == (2, 3, 4, 5) and g[0].dtype == np.float32
        np.testing.assert_allclose(g[0], w[0], rtol=0, atol=PREP_TOL)
        assert g[1].tobytes() == np.asarray(w[1]).astype('int64').tobytes()


def _program_state(program):
    blk = program.global_block()
    return [op.type for op in blk.ops], sorted(blk.vars)


@pytest.mark.parametrize('pkg', ['jax', 'port'])
def test_a_failed_preprocessor_block_leaves_the_programs(pkg):
    _, fluid, _, _ = PKGS[pkg]
    with _programs(fluid) as (main, startup, _):
        reader = fluid.layers.py_reader(capacity=2, shapes=[[-1, 3]],
                                        dtypes=['float32'], name='r')
        w = fluid.layers.create_parameter(shape=[3], dtype='float32',
                                          name='kept')
        fluid.layers.scale(w, scale=2.0)
        before = _program_state(main), _program_state(startup)
        kw = {} if pkg == 'jax' else {'place': fluid.CPUPlace()}
        p = fluid.layers.Preprocessor(reader, **kw)
        with pytest.raises(KeyError):
            with p.block():
                x, = p.inputs()
                m = fluid.layers.create_parameter(shape=[3], dtype='float32',
                                                  name='dropped')
                fluid.layers.elementwise_add(x, m)
                raise KeyError('the block fails')
        assert (_program_state(main), _program_state(startup)) == before
        with pytest.raises(ValueError):
            with p.block():
                p.inputs()


def test_load_puts_the_file_in_the_scope_on_its_device(tmp_path):
    a = np.random.RandomState(3).randn(4, 2).astype('float32')
    np.save(str(tmp_path / 'w.npy'), a)
    with _programs(tfluid) as (main, _, scope):
        v = tfluid.layers.create_parameter(shape=[4, 2], dtype='float32',
                                           name='w')
        assert tfluid.layers.load(v, str(tmp_path / 'w')) is v
        got = scope.vars['w']
        assert isinstance(got, torch.Tensor) and got.device.type == 'cpu'
        assert got.numpy().tobytes() == a.tobytes()
        tfluid.layers.load(v, str(tmp_path / 'w.npy'))
        assert scope.vars['w'].numpy().tobytes() == a.tobytes()
    with _programs(jfluid) as (_, _, jscope):
        jv = jfluid.layers.create_parameter(shape=[4, 2], dtype='float32',
                                            name='w')
        jfluid.layers.load(jv, str(tmp_path / 'w'))
        assert np.asarray(jscope.vars['w']).tobytes() == a.tobytes()


def _cifar_losses(fluid, resnet, path, init=None):
    """resnet_cifar10(depth=8) over open_recordio_file -> batch(4) ->
    double_buffer of cifar samples, 3 Momentum steps from `init` (the JAX
    startup weights) or the package's own startup."""
    with _programs(fluid) as (main, startup, scope):
        avg_cost, _, _, _ = resnet.get_model(data_set='cifar10', depth=8,
                                             batch_size=4)
        blk = main.global_block()
        feeder = fluid.DataFeeder([blk.var('data'), blk.var('label')],
                                  fluid.CPUPlace(), program=main)
        r = fluid.layers.open_recordio_file(
            path, shapes=[[-1, 3, 32, 32], [-1, 1]], lod_levels=[0, 0],
            dtypes=['float32', 'int64'])
        r = fluid.layers.double_buffer(fluid.layers.batch(r, batch_size=4))
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        if init is None:
            init = {n: np.array(v, copy=True) for n, v in scope.vars.items()}
        else:
            scope.load_numpy(init, fluid.CPUPlace())
        losses = [float(np.asarray(exe.run(main, feed=feeder.feed(b),
                                           fetch_list=[avg_cost])[0])[0])
                  for b in r()]
    return init, losses


def test_resnet_cifar10_trains_from_a_recordio_chain_in_both(tmp_path):
    path = str(tmp_path / 'cifar.ptrio')
    samples = [(img, np.int64(label)) for img, label in
               list(tpaddle.dataset.cifar.train10()())[:12]]
    assert trio.write_samples(path, iter(samples)) == 12
    init, jl = _cifar_losses(jfluid, jresnet, path)
    _, tl = _cifar_losses(tfluid, tresnet, path, init)
    assert len(tl) == len(jl) == 3
    np.testing.assert_allclose(tl, jl, rtol=LOSS_TOL, atol=LOSS_TOL)
    assert abs(jl[2] - jl[0]) > 1e-3


def _no_card():
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present: the no-card contract does not '
                    'apply')


def test_entry_points_need_the_card_unless_asked_for_the_cpu():
    _no_card()
    with _programs(tfluid):
        r = tfluid.layers.py_reader(capacity=2, shapes=[[-1, 3]],
                                    dtypes=['float32'], name='r')
        r.decorate_paddle_reader(lambda: iter([]))
        with pytest.raises(RuntimeError, match='no CUDA device'):
            tfluid.layers.Preprocessor(r)
        with pytest.raises(RuntimeError, match='no CUDA device'):
            tfluid.layers.double_buffer(r, place=tfluid.CUDAPlace(0))
        tfluid.layers.double_buffer(r, place=tfluid.CPUPlace())
        assert list(r()) == []
