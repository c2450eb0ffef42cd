"""The port's reader package (reader/__init__.py, creator.py, decorator.py,
pipeline.py) and utils.retry against the JAX package's, on the same
inputs:

  * every decorator gives the JAX decorator's samples in the JAX order:
    shuffle under the same `random` seed, shard, chain, compose (aligned,
    misaligned raising ComposeNotAligned, check_alignment off), buffered,
    firstn, xmap_readers ordered (and unordered as a multiset), cache,
    Fake, PipeReader (plain, gzip, a failing command);
  * errors reach the consumer: a mapper's or a source's exception out of
    xmap_readers and buffered, a prefetch worker's exception with its
    traceback;
  * fault_tolerant retries a flaky source without duplicates or gaps, on
    the JAX backoff schedule, and degrades with the JAX warning;
  * pipeline.prefetch and bundle give the JAX streams; an early close of
    a prefetch unblocks its worker, and its transform runs on the worker;
  * creator.np_array and text_file, and the decorator module's names.
"""
import gzip
import random
import threading
import time
import warnings

import numpy as np
import pytest

import jax  # noqa: F401  (conftest pins it to the CPU)

import paddle_tpu.reader as jreader
from paddle_tpu.reader import creator as jcreator
from paddle_tpu.reader import decorator as jdecorator
from paddle_tpu.reader import pipeline as jpipeline
from paddle_tpu.utils import retry as jretry

import paddle_tpu_torch as tpaddle
import paddle_tpu_torch.reader as treader
from paddle_tpu_torch.reader import creator as tcreator
from paddle_tpu_torch.reader import decorator as tdecorator
from paddle_tpu_torch.reader import pipeline as tpipeline
from paddle_tpu_torch.utils import retry as tretry

BOTH = [('jax', jreader, jpipeline, jcreator),
        ('port', treader, tpipeline, tcreator)]


def _src(n=23):
    return lambda: iter(range(n))


def _pairs(n=7):
    return lambda: iter([(i, -i) for i in range(n)])


def _both(fn):
    """fn(reader package, pipeline, creator) run on both packages."""
    return [fn(r, p, c) for _, r, p, c in BOTH]


def test_the_port_keeps_the_jax_reader_names():
    assert treader.__all__ == jreader.__all__
    assert tdecorator.__all__ == jdecorator.__all__
    assert tpipeline.__all__ == jpipeline.__all__
    assert tcreator.__all__ == jcreator.__all__
    for name in tdecorator.__all__:
        assert getattr(tdecorator, name) is getattr(treader, name)
    assert tpaddle.reader is treader
    assert issubclass(treader.ComposeNotAligned, ValueError)
    assert treader.XmapEndSignal is not None


@pytest.mark.parametrize('case', [
    'map_readers', 'chain', 'compose', 'compose_unchecked', 'buffered',
    'firstn', 'firstn_past_end', 'cache', 'shard_0', 'shard_2'])
def test_decorator_gives_the_jax_stream(case):
    def run(r, p, c):
        if case == 'map_readers':
            rd = r.map_readers(lambda a, b: a * 10 + b, _src(9), _src(5))
        elif case == 'chain':
            rd = r.chain(_src(4), _pairs(3), _src(2))
        elif case == 'compose':
            rd = r.compose(_src(6), _pairs(6))
        elif case == 'compose_unchecked':
            rd = r.compose(_src(6), _pairs(4), check_alignment=False)
        elif case == 'buffered':
            rd = r.buffered(_src(40), 3)
        elif case == 'firstn':
            rd = r.firstn(_src(), 5)
        elif case == 'firstn_past_end':
            rd = r.firstn(_src(3), 9)
        elif case == 'cache':
            calls = []

            def once():
                calls.append(1)
                return iter(range(5))
            cached = r.cache(once)
            first = list(cached())
            assert list(cached()) == first and len(calls) == 1
            return first
        else:
            rd = r.shard(_src(23), 3, int(case[-1]))
        return list(rd())

    jgot, tgot = _both(run)
    assert tgot == jgot


@pytest.mark.parametrize('buf_size', [1, 4, 100])
def test_shuffle_under_the_same_seed_gives_the_jax_order(buf_size):
    def run(r, p, c):
        random.seed(7)
        return list(r.shuffle(_src(30), buf_size)())

    jgot, tgot = _both(run)
    assert tgot == jgot and sorted(tgot) == list(range(30))


def test_shard_rejects_what_jax_rejects():
    for args in ((0, 0), (2, 2), (2, -1)):
        with pytest.raises(ValueError) as je:
            jreader.shard(_src(), *args)
        with pytest.raises(ValueError) as te:
            treader.shard(_src(), *args)
        assert str(te.value) == str(je.value)


def test_misaligned_compose_raises_like_jax():
    def run(r, p, c):
        got = []
        with pytest.raises(r.ComposeNotAligned) as e:
            for x in r.compose(_src(5), _src(3))():
                got.append(x)
        return got, str(e.value)

    jgot, tgot = _both(run)
    assert tgot == jgot


@pytest.mark.parametrize('order', [True, False])
def test_xmap_readers_like_jax(order):
    def mapper(x):
        time.sleep(0.001 * ((x * 7) % 3))   # out-of-order finishes
        return x * x

    def run(r, p, c):
        return list(r.xmap_readers(mapper, _src(40), 4, 8, order=order)())

    jgot, tgot = _both(run)
    if order:
        assert tgot == jgot == [x * x for x in range(40)]
    else:
        assert sorted(tgot) == sorted(jgot)


@pytest.mark.parametrize('where', ['mapper', 'source'])
def test_xmap_readers_raises_the_error_at_the_consumer(where):
    def mapper(x):
        if where == 'mapper' and x == 5:
            raise KeyError('bad sample 5')
        return x

    def source():
        yield from range(5)
        if where == 'source':
            raise IOError('shard lost')

    for r in (jreader, treader):
        with pytest.raises((KeyError, IOError)):
            list(r.xmap_readers(mapper, source if where == 'source'
                                else _src(20), 3, 4, order=True)())


def test_buffered_raises_a_source_error_at_the_consumer():
    def source():
        yield 1
        raise IOError('disk gone')

    for r in (jreader, treader):
        got = []
        with pytest.raises(IOError, match='disk gone'):
            for x in r.buffered(source, 2)():
                got.append(x)
        assert got == [1]


def test_fake_replays_the_first_sample_like_jax():
    def run(r, p, c):
        fake = r.Fake()
        rd = fake(_pairs(5), 4)
        return list(rd()), list(rd())

    jgot, tgot = _both(run)
    assert tgot == jgot == ([(0, 0)] * 4, [(0, 0)] * 4)


def test_pipe_reader_like_jax(tmp_path):
    text = 'alpha\nbeta gamma\n\ndelta é\nlast'
    p = tmp_path / 'data.txt'
    p.write_text(text, encoding='utf-8')
    gz = tmp_path / 'data.txt.gz'
    with gzip.open(str(gz), 'wb') as f:
        f.write(text.encode('utf-8'))

    def run(r, pipe, c):
        plain = list(r.PipeReader('cat %s' % p, bufsize=3).get_line())
        unz = list(r.PipeReader('cat %s' % gz, file_type='gzip').get_line())
        raw = ''.join(r.PipeReader('cat %s' % p, bufsize=4).get_line(
            cut_lines=False))
        with pytest.raises(IOError):
            list(r.PipeReader('cat %s' % (tmp_path / 'nope')).get_line())
        with pytest.raises(TypeError):
            r.PipeReader('cat x', file_type='bz2')
        return plain, unz, raw

    jgot, tgot = _both(run)
    assert tgot == jgot
    assert tgot[0] == text.split('\n') and tgot[2] == text


class _Flaky(object):
    """A source that fails with IOError at sample `fail_at`, `fail_times`
    times (a re-open restarts it from the beginning)."""

    def __init__(self, n, fail_at, fail_times):
        self.n, self.fail_at, self.left = n, fail_at, fail_times
        self.opens = 0

    def __call__(self):
        self.opens += 1
        for i in range(self.n):
            if i == self.fail_at and self.left > 0:
                self.left -= 1
                raise IOError('transient read error %d' % self.left)
            yield i


@pytest.mark.parametrize('fail_times', [2, 99])
def test_fault_tolerant_retries_and_degrades_like_jax(fail_times):
    def run(r, p, c):
        src = _Flaky(10, fail_at=4, fail_times=fail_times)
        slept = []
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter('always')
            got = list(r.fault_tolerant(src, max_retries=3, seed=5,
                                        sleep=slept.append)())
        msgs = [str(w.message) for w in rec
                if issubclass(w.category, RuntimeWarning)]
        return got, slept, src.opens, msgs

    jgot, tgot = _both(run)
    assert tgot == jgot
    got, slept, opens, msgs = tgot
    if fail_times == 2:
        assert got == list(range(10)) and len(slept) == 2 and not msgs
    else:
        assert got == [0, 1, 2, 3] and opens == 4
        assert len(msgs) == 1 and 'degrading to skip' in msgs[0]


def test_retry_schedule_and_retry_call_like_jax():
    for kw in (dict(seed=42), dict(seed=1, jitter=0.0, factor=3.0),
               dict(seed=9, max_delay=0.3)):
        assert list(tretry.backoff_delays(6, **kw)) \
            == list(jretry.backoff_delays(6, **kw))

    def run(mod):
        calls, slept = [], []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise OSError('again')
            return 'done'
        out = mod.retry_call(flaky, retries=4, seed=3, sleep=slept.append)
        with pytest.raises(mod.RetryError) as e:
            mod.retry_call(lambda: (_ for _ in ()).throw(OSError('dead')),
                           retries=2, seed=3, sleep=lambda d: None)
        return out, slept, e.value.attempts

    assert run(tretry) == run(jretry)


def test_prefetch_and_bundle_give_the_jax_streams():
    def run(r, p, c):
        return (list(p.prefetch(_src(17), depth=3)()),
                list(p.prefetch(_src(9), depth=1,
                                transform=lambda x: (x, x * 2))()),
                list(p.bundle(_src(7), 3)()),
                list(p.bundle(_src(7), 3, drop_last=True)()),
                list(p.bundle(lambda: iter([]), 3)()))

    jgot, tgot = _both(run)
    assert tgot == jgot
    with pytest.raises(ValueError):
        tpipeline.bundle(_src(3), 0)


def test_prefetch_reraises_a_worker_error_with_its_traceback():
    def broken():
        yield 1
        yield 2
        raise IOError('reader shard corrupt')

    for p in (jpipeline, tpipeline):
        got = []
        with pytest.raises(IOError, match='shard corrupt') as e:
            for item in p.prefetch(lambda: broken(), depth=2)():
                got.append(item)
        assert got == [1, 2]
        assert any(tb.name == 'broken' for tb in e.traceback)


def test_prefetch_early_close_unblocks_the_worker():
    produced = []

    def infinite():
        i = 0
        while True:
            produced.append(i)
            yield i
            i += 1

    before = threading.active_count()
    it = tpipeline.prefetch(lambda: infinite(), depth=1)()
    assert next(it) == 0 and next(it) == 1
    it.close()
    deadline = time.monotonic() + 5.0
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.01)
    assert threading.active_count() <= before, \
        'prefetch worker still alive after the consumer closed'
    n = len(produced)
    time.sleep(0.2)
    assert len(produced) == n


def test_prefetch_early_break_unblocks_the_worker():
    before = threading.active_count()
    got = []
    for x in tpipeline.prefetch(_src(10 ** 6), depth=2)():
        got.append(x)
        if x == 3:
            break
    deadline = time.monotonic() + 5.0
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.01)
    assert got == [0, 1, 2, 3] and threading.active_count() <= before


def test_prefetch_transform_runs_on_the_worker():
    main = threading.get_ident()
    seen = set()

    def stage(x):
        seen.add(threading.get_ident())
        return x * 10

    assert list(tpipeline.prefetch(_src(5), depth=2, transform=stage)()) \
        == [0, 10, 20, 30, 40]
    assert seen and main not in seen


def test_creators_like_jax(tmp_path):
    arr = np.arange(24, dtype='float32').reshape(6, 4)
    p = tmp_path / 'lines.txt'
    p.write_text('one\ntwo\n\nthree\n')

    def run(r, pipe, c):
        return ([row.tolist() for row in c.np_array(arr)()],
                list(c.text_file(str(p))()))

    jgot, tgot = _both(run)
    assert tgot == jgot
    assert tgot[1] == ['one', 'two', '', 'three']
