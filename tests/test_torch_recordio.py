"""The port's record files, native host library and batched transform
(reader/recordio.py, fluid/recordio_writer.py, utils/native.py,
csrc/recordio.cpp, csrc/image_aug.cpp, dataset/image.py) against the JAX
package's, on the CPU, on the same seeded numpy inputs:

  * files of write_samples and of fluid.recordio_writer are the JAX
    package's byte for byte (but a LoD slot's int64 data, int32 in JAX's
    with x64 off), and each package reads the other's through its native
    scanner (plain and prefetching) and its pure python reader;
  * a truncated file and a flipped payload byte raise IOError in both
    packages, by every reader;
  * simple_transform_batch is bitwise the JAX package's native routine and
    bitwise the port's own plain numpy version, over odd and even sizes, 1
    and 3 channels, train and test, with and without a mean, and several
    seeds;
  * the native library builds into its hash-named path, is rebuilt after
    an edit, and a build from a broken source raises with the compiler's
    output; with that library in place the readers and the transform
    raise too (no python fallback).
"""
import os
import shutil
import threading

import numpy as np
import pytest

import jax  # noqa: F401  (conftest pins it to the CPU)

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import recordio_writer as jwriter
from paddle_tpu.reader import creator as jcreator
from paddle_tpu.reader import recordio as jrio
from paddle_tpu.utils import native as jnative

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.dataset import image as timage
from paddle_tpu_torch.fluid import recordio_writer as twriter
from paddle_tpu_torch.reader import creator as tcreator
from paddle_tpu_torch.reader import recordio as trio
from paddle_tpu_torch.utils import native as tnative


def _samples(n=24, seed=0):
    r = np.random.RandomState(seed)
    out = []
    for i in range(n):
        out.append((r.randn(4, 3).astype('float32'),
                    r.randint(0, 9, size=(2,)).astype('int64'),
                    (r.rand(3, 5, 2) * 255).astype('uint8'),
                    np.array(r.randn(), 'float64'),
                    np.zeros((0, 3), 'int32') if i % 5 == 0
                    else r.randint(-5, 5, size=(i % 4 + 1, 3)).astype(
                        'int32')))
    return out


def _same_samples(got, want):
    """Each array as written; a 0-d array comes back of shape (1,) in both
    packages (_pack_sample writes np.ascontiguousarray's view)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            b = np.ascontiguousarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()


def _read(path, how):
    if how == 'port_prefetch':
        return list(trio.read_samples(path, prefetch_depth=3))
    if how == 'port_scanner':
        return list(trio.read_samples(path, prefetch_depth=0))
    if how == 'port_python':
        return [trio._unpack_sample(p) for p in trio.RecordIOReader(path)]
    if how == 'jax_native':
        assert jnative.available()
        return list(jrio.read_samples(path))
    return [jrio._unpack_sample(p) for p in jrio.RecordIOReader(path)]


READERS = ['port_prefetch', 'port_scanner', 'port_python', 'jax_native',
           'jax_python']


@pytest.mark.parametrize('how', READERS)
@pytest.mark.parametrize('writer', ['jax', 'port'])
def test_write_samples_files_are_the_jax_files_and_read_both_ways(
        tmp_path, writer, how):
    samples = _samples()
    pj, pt = str(tmp_path / 'j.ptrio'), str(tmp_path / 't.ptrio')
    assert jrio.write_samples(pj, iter(samples)) == len(samples)
    assert trio.write_samples(pt, iter(samples)) == len(samples)
    with open(pj, 'rb') as f, open(pt, 'rb') as g:
        assert f.read() == g.read()
    _same_samples(_read(pj if writer == 'jax' else pt, how), samples)


def test_native_writer_and_prefetch_depths(tmp_path):
    """NativeRecordWriter writes the python writer's bytes; the prefetch
    thread gives the scanner's payloads at every depth, records of 0 bytes
    to 1 MB included, and a consumer that stops early closes it."""
    r = np.random.RandomState(3)
    payloads = [b''] + [r.bytes(int(n)) for n in
                        r.randint(1, 4096, size=40)] + [r.bytes(1 << 20)]
    pn, pp = str(tmp_path / 'n.ptrio'), str(tmp_path / 'p.ptrio')
    with tnative.NativeRecordWriter(pn) as w:
        for p in payloads:
            w.write(p)
    with trio.RecordIOWriter(pp) as w:
        for p in payloads:
            w.write(p)
    with open(pn, 'rb') as f, open(pp, 'rb') as g:
        assert f.read() == g.read()
    assert list(tnative.recordio_iter(pn)) == payloads
    for depth in (1, 2, 4, 64):
        assert list(tnative.recordio_prefetch_iter(pn, depth)) == payloads
    it = tnative.recordio_prefetch_iter(pn, 2)
    assert next(it) == b'' and next(it) == payloads[1]
    it.close()
    assert list(tcreator.recordio([pn, pp])()) == payloads * 2
    assert list(tcreator.recordio(pn + ',' + pp)()) == \
        list(jcreator.recordio(pn + ',' + pp)())


def _feeders(lod):
    """A DataFeeder of two slots (a LoD int64 word slot when `lod` is 1 or
    2, else a dense float32 [3] slot; an int64 label) in each package."""
    out = []
    for fluid in (jfluid, tfluid):
        main = fluid.Program()
        with fluid.program_guard(main, fluid.Program()):
            if lod:
                x = fluid.layers.data(name='x', shape=[1], dtype='int64',
                                      lod_level=lod)
            else:
                x = fluid.layers.data(name='x', shape=[3], dtype='float32')
            y = fluid.layers.data(name='y', shape=[1], dtype='int64')
            out.append(fluid.DataFeeder([x, y], fluid.CPUPlace(),
                                        program=main))
    return out


def _batches(lod, n=5, bs=3, seed=0):
    r = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        b = []
        for _ in range(bs):
            if lod == 2:
                x = [[int(v) for v in r.randint(0, 50, size=r.randint(1, 4))]
                     for _ in range(r.randint(1, 3))]
            elif lod == 1:
                x = [int(v) for v in r.randint(0, 50, size=r.randint(1, 7))]
            else:
                x = r.randn(3).astype('float32')
            b.append((x, int(r.randint(0, 2))))
        out.append(b)
    return out


def _slots_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if hasattr(w, 'recursive_sequence_lengths'):
            assert g.recursive_sequence_lengths() == \
                w.recursive_sequence_lengths()
            g, w = g.data, w.data
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


def _jax_payload_of(port_payload):
    """The record the JAX package writes for the same batch: the port's,
    with each integer LoD slot's data as int32. The JAX DataFeeder makes a
    sequence slot a jnp array, and with x64 off an int64 slot's data is
    int32 there; the port keeps the declared int64 (ROADMAP.md, known
    departures). Every other byte is the same."""
    arrs = list(trio._unpack_sample(port_payload))
    schema = arrs[0]
    i = 1
    for s in range(int(schema[0])):
        levels = int(schema[1 + s])
        if levels and arrs[i].dtype == np.int64:
            arrs[i] = arrs[i].astype(np.int32)
        i += 1 + levels
    return trio._pack_sample(arrs)


def _same_files(jax_path, port_path):
    jp = list(jrio.RecordIOReader(jax_path))
    tp = list(jrio.RecordIOReader(port_path))
    assert len(jp) == len(tp)
    for a, b in zip(jp, tp):
        assert a == _jax_payload_of(b)


@pytest.mark.parametrize('lod', [0, 1, 2])
def test_recordio_writer_files_are_the_jax_files(tmp_path, lod):
    """convert_reader_to_recordio_file(s) over each package's DataFeeder
    write the same files (dense slots byte for byte; a LoD slot's int64
    data as int32 in JAX), and unpack_feed_record gives the same slots,
    LoD lengths included, from either file in either package."""
    jfeed, tfeed = _feeders(lod)
    batches = _batches(lod)
    pj, pt = str(tmp_path / 'j.rec'), str(tmp_path / 't.rec')
    assert jwriter.convert_reader_to_recordio_file(
        pj, lambda: iter(batches), jfeed) == len(batches)
    assert twriter.convert_reader_to_recordio_file(
        pt, lambda: iter(batches), tfeed) == len(batches)
    _same_files(pj, pt)
    with open(pj, 'rb') as f, open(pt, 'rb') as g:
        assert (f.read() == g.read()) == (lod == 0)
    for path in (pj, pt):
        for jp, tp in zip(jrio.RecordIOReader(path),
                          tnative.recordio_iter(path)):
            _slots_equal(twriter.unpack_feed_record(tp),
                         jwriter.unpack_feed_record(jp))
    # split files: the same names and records
    nj = jwriter.convert_reader_to_recordio_files(
        str(tmp_path / 'js.rec'), 2, lambda: iter(batches), jfeed)
    nt = twriter.convert_reader_to_recordio_files(
        str(tmp_path / 'ts.rec'), 2, lambda: iter(batches), tfeed)
    assert nj == nt == len(batches)
    for i in range(3):
        _same_files(str(tmp_path / ('js-%05d.rec' % i)),
                    str(tmp_path / ('ts-%05d.rec' % i)))
    assert not os.path.exists(str(tmp_path / 'ts-00003.rec'))


def _broken_copies(tmp_path, samples):
    p = str(tmp_path / 'good.ptrio')
    trio.write_samples(p, iter(samples))
    with open(p, 'rb') as f:
        raw = f.read()
    cut_header = str(tmp_path / 'cut_header.ptrio')
    cut_payload = str(tmp_path / 'cut_payload.ptrio')
    flipped = str(tmp_path / 'flipped.ptrio')
    with open(cut_header, 'wb') as f:
        f.write(raw + b'\x05\x00\x00')          # 3 bytes of a next header
    with open(cut_payload, 'wb') as f:
        f.write(raw[:-7])
    bad = bytearray(raw)
    bad[len(raw) // 2] ^= 0x40
    with open(flipped, 'wb') as f:
        f.write(bytes(bad))
    return {'cut_header': cut_header, 'cut_payload': cut_payload,
            'flipped': flipped}


@pytest.mark.parametrize('how', READERS)
@pytest.mark.parametrize('fault', ['cut_header', 'cut_payload', 'flipped'])
def test_truncation_and_checksum_errors_raise_ioerror(tmp_path, fault, how):
    path = _broken_copies(tmp_path, _samples(8, seed=4))[fault]
    with pytest.raises(IOError):
        _read(path, how)


def test_a_file_of_another_format_raises(tmp_path):
    p = str(tmp_path / 'x.txt')
    with open(p, 'wb') as f:
        f.write(b'not a record file at all')
    with pytest.raises(IOError):
        list(trio.read_samples(p))
    with pytest.raises(IOError):
        list(trio.read_samples(p, prefetch_depth=0))
    with pytest.raises(ValueError):
        list(trio.RecordIOReader(p))
    with pytest.raises(IOError):
        list(trio.read_samples(str(tmp_path / 'missing.ptrio')))


# -- the batched transform -------------------------------------------------

_SIZES = [(3, 17, 23, 3), (2, 24, 16, 1), (4, 30, 30, 3), (2, 20, 21, 3),
          (3, 14, 14, 3), (2, 15, 40, 1)]


def _means(c, crop, r):
    return [None, [1.5], list(r.uniform(0, 200, size=c)),
            r.uniform(0, 200, size=(c, crop, crop)).astype('float32')]


@pytest.mark.parametrize('is_train', [True, False])
@pytest.mark.parametrize('size', _SIZES)
def test_transform_is_bitwise_jax_native_and_the_plain_version(size,
                                                               is_train):
    assert jnative.available()
    n, h, w, c = size
    r = np.random.RandomState(sum(size))
    images = (r.rand(n, h, w, c) * 255).astype('uint8')
    for mean in _means(c, 12, r):
        for seed in (0, 1, 7, 12345, 2 ** 63 + 5):
            want = jnative.image_transform_batch(images, 14, 12, is_train,
                                                 mean=mean, seed=seed)
            got = timage.simple_transform_batch(images, 14, 12, is_train,
                                                mean=mean, seed=seed)
            plain = timage._transform_batch_plain(images, 14, 12, is_train,
                                                  mean=mean, seed=seed)
            assert got.shape == (n, c, 12, 12) and got.dtype == np.float32
            assert got.tobytes() == want.tobytes(), (mean, seed)
            assert plain.tobytes() == got.tobytes(), (mean, seed)


def test_transform_at_the_flowers_size():
    """The ResNet input path's shapes (256x320 raw, resize 256, crop 224,
    the flowers mean), and a resize that does work (300x200 to 256)."""
    r = np.random.RandomState(5)
    mean = [103.94, 116.78, 123.68]
    for shape in ((4, 256, 320, 3), (3, 300, 200, 3)):
        images = (r.rand(*shape) * 255).astype('uint8')
        for seed in (0, 9):
            got = timage.simple_transform_batch(images, 256, 224, True,
                                                mean=mean, seed=seed)
            assert got.tobytes() == jnative.image_transform_batch(
                images, 256, 224, True, mean=mean, seed=seed).tobytes()
            assert got.tobytes() == timage._transform_batch_plain(
                images, 256, 224, True, mean=mean, seed=seed).tobytes()
    # the train crops move with the seed, and a test crop is the centre
    a = timage.simple_transform_batch(images, 256, 224, True, seed=1)
    b = timage.simple_transform_batch(images, 256, 224, True, seed=2)
    assert a.tobytes() != b.tobytes()
    c = timage.simple_transform_batch(images, 256, 224, False, seed=1)
    d = timage.simple_transform_batch(images, 256, 224, False, seed=2)
    assert c.tobytes() == d.tobytes()


def test_transform_rejects_what_the_routine_cannot_do():
    """Where the JAX wrapper returns None and its caller falls back to a
    numpy path of other crops, the port raises."""
    images = np.zeros((2, 20, 20, 3), 'uint8')
    with pytest.raises(ValueError):
        timage.simple_transform_batch(images, 14, 12, True, mean=[1.0, 2.0])
    assert jnative.image_transform_batch(images, 14, 12, True,
                                         mean=[1.0, 2.0]) is None
    for bad in (dict(resize_size=10, crop_size=12),
                dict(resize_size=14, crop_size=0)):
        with pytest.raises(ValueError):
            timage.simple_transform_batch(images, is_train=True, **bad)
        with pytest.raises(ValueError):
            timage._transform_batch_plain(images, is_train=True, **bad)
    with pytest.raises(ValueError):
        timage.simple_transform_batch(images[0], 14, 12, True)


# -- the build -------------------------------------------------------------

def _copy_sources(tmp_path):
    root = str(tmp_path / 'pkg')
    shutil.copytree(os.path.join(tnative._PKG_DIR, 'csrc'),
                    os.path.join(root, 'csrc'))
    return root


def test_the_library_builds_hash_named_and_rebuilds_after_an_edit(tmp_path):
    root = _copy_sources(tmp_path)
    build = str(tmp_path / 'build')
    libs = [tnative.NativeLibrary(root=root, build_dir=build)
            for _ in range(3)]
    paths = []
    threads = [threading.Thread(target=lambda l=l: paths.append(l.build()))
               for l in libs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(set(paths)) == 1 and os.path.exists(paths[0])
    assert os.listdir(build) == [os.path.basename(paths[0])]
    assert libs[0].load().ptim_transform_batch is not None
    with open(os.path.join(root, 'csrc', 'image_aug.cpp'), 'a') as f:
        f.write('\n// an edit\n')
    fresh = tnative.NativeLibrary(root=root, build_dir=build)
    assert fresh.library_path() != paths[0]
    assert os.path.exists(fresh.build())
    # the package's own library is where the module says
    assert os.path.dirname(tnative.LIBRARY.library_path()) == \
        os.path.join(tnative._PKG_DIR, 'build')


def test_a_broken_source_raises_and_nothing_falls_back(tmp_path,
                                                       monkeypatch):
    root = _copy_sources(tmp_path)
    with open(os.path.join(root, 'csrc', 'recordio.cpp'), 'a') as f:
        f.write('\nthis is not C++;\n')
    broken = tnative.NativeLibrary(root=root,
                                   build_dir=str(tmp_path / 'build'))
    with pytest.raises(RuntimeError) as e:
        broken.build()
    assert 'recordio.cpp' in str(e.value) and 'error' in str(e.value)
    assert not os.listdir(str(tmp_path / 'build'))   # no temp left behind
    # with that library in place every native entry raises: no python path
    monkeypatch.setattr(tnative, 'LIBRARY', broken)
    p = str(tmp_path / 's.ptrio')
    trio.write_samples(p, iter(_samples(3)))
    for depth in (0, 4):
        with pytest.raises(RuntimeError):
            list(trio.read_samples(p, prefetch_depth=depth))
    with pytest.raises(RuntimeError):
        timage.simple_transform_batch(np.zeros((1, 8, 8, 3), 'uint8'), 8,
                                      8, False)
    with pytest.raises(RuntimeError):
        tnative.NativeRecordWriter(str(tmp_path / 'w.ptrio'))
    # the pure python reader is public API and does not need the library
    assert len(list(trio.RecordIOReader(p))) == 3


def test_no_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(tnative.shutil, 'which', lambda name: None)
    lib = tnative.NativeLibrary(root=_copy_sources(tmp_path),
                                build_dir=str(tmp_path / 'build'))
    with pytest.raises(RuntimeError, match='no host C\\+\\+ compiler'):
        lib.build()
