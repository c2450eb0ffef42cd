"""The reader layers on the card (marker cuda; they skip without one): no
JAX here, the card's machine has none.

  * double_buffer(place=CUDAPlace(0)) stages each item into pinned host
    memory on its prefetch thread: an ndarray pinned, a LoDTensor slot of a fluid.recordio_writer record as the padded SeqValue
    the Executor makes of it, anything else as it is;
  * a Preprocessor on the card gives the CPU Preprocessor's stream.

Run on the card: python -m pytest tests/test_torch_recordio_cuda.py -m cuda
--noconftest
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import recordio_writer
from paddle_tpu_torch.fluid.layers import io as tio

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card (pinned host memory, the card)')
    return fluid.CUDAPlace(0)


def _programs():
    main, startup = fluid.Program(), fluid.Program()
    return main, startup


def test_double_buffer_stages_into_pinned_memory(card, tmp_path):
    r = np.random.RandomState(2)
    batches = [[([int(v) for v in r.randint(0, 40, size=r.randint(1, 6))],
                 int(r.randint(0, 2))) for _ in range(3)] for _ in range(4)]
    main, startup = _programs()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name='x', shape=[1], dtype='int64',
                              lod_level=1)
        y = fluid.layers.data(name='y', shape=[1], dtype='int64')
        feeder = fluid.DataFeeder([x, y], fluid.CPUPlace(), program=main)
        path = str(tmp_path / 'f.rec')
        recordio_writer.convert_reader_to_recordio_file(
            path, lambda: iter(batches), feeder)
        want = [feeder.feed(b) for b in batches]
        rd = fluid.layers.open_recordio_file(
            path, shapes=[[-1, 1], [-1, 1]], lod_levels=[1, 0],
            dtypes=['int64', 'int64'])
        rd = fluid.layers.double_buffer(rd, place=card)
        got = list(rd())
    assert len(got) == len(want)
    for (gx, gy), feed in zip(got, want):
        assert gx.data.is_pinned() and gx.lengths.is_pinned()
        assert gy.is_pinned()
        assert torch.equal(gx.data, feed['x'].data)
        assert torch.equal(gx.lengths, feed['x'].lengths)
        assert gy.numpy().tobytes() == feed['y'].tobytes()
    staged = tio._staged((np.arange(6, dtype='float32').reshape(2, 3),
                          [np.array([4])], 'tag', np.int64(5)))
    assert staged[0].is_pinned()
    assert staged[0].tolist() == [[0, 1, 2], [3, 4, 5]]
    assert isinstance(staged[1], list) and staged[1][0].is_pinned()
    assert staged[2] == 'tag' and staged[3] == 5    # scalars pass as they are


def _preprocessed(place, raw):
    main, startup = _programs()
    scope = fluid.Scope()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup), \
            fluid.scope_guard(scope):
        reader = fluid.layers.py_reader(
            capacity=2, shapes=[[-1, 4, 5, 3], [-1, 1]],
            dtypes=['uint8', 'int64'], name='raw')
        reader.decorate_paddle_reader(lambda: iter(raw))
        p = fluid.layers.Preprocessor(reader, place=place)
        with p.block():
            img, label = p.inputs()
            x = fluid.layers.scale(fluid.layers.cast(img, 'float32'),
                                   scale=1.0 / 255.0)
            mean = fluid.layers.create_parameter(
                shape=[3], dtype='float32', name='mean',
                default_initializer=fluid.initializer.NumpyArrayInitializer(
                    np.array([0.1, 0.5, 0.3], 'float32')))
            x = fluid.layers.transpose(
                fluid.layers.elementwise_sub(x, mean, axis=-1),
                perm=[0, 3, 1, 2])
            p.outputs(x, label)
        fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
        return list(reader())


def test_preprocessor_on_the_card_is_the_cpu_stream(card):
    r = np.random.RandomState(7)
    raw = [((r.rand(2, 4, 5, 3) * 255).astype('uint8'),
            r.randint(0, 10, size=(2, 1)).astype('int64')) for _ in range(3)]
    got = _preprocessed(card, raw)
    want = _preprocessed(fluid.CPUPlace(), raw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[0], w[0], rtol=0, atol=1e-6)
        assert g[1].tobytes() == w[1].tobytes()
