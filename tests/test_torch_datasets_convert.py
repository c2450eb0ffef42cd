"""The port's dataset plumbing and converters (dataset/common.py,
dataset/image.py's file helpers, mq2007, sentiment, voc2012, and every
dataset's `convert`) against the JAX package's, on the CPU:

  * mq2007 (pairwise and pointwise), sentiment and voc2012 yield the JAX
    package's samples bitwise;
  * each dataset's convert writes the JAX package's shard names, and its
    shards read back through JAX's reader.creator.recordio to the samples
    of the port's own reader;
  * split, cluster_files_reader, md5file and data_path; download without a
    fetcher (the cache or None), with a flaky fetcher (retried), and with a
    fetcher whose md5 is wrong (raises, the cache left empty);
  * uci_housing.feature_range and wmt16.fetch return None, as in JAX;
  * load_image_bytes, load_image, load_and_transform and
    batch_images_from_tar give the JAX package's arrays and files.
"""
import hashlib
import io
import os
import pickle
import tarfile

import numpy as np
import pytest

import jax  # noqa: F401  (conftest pins it to the CPU)

import paddle_tpu.dataset as jdataset
from paddle_tpu.dataset import common as jcommon
from paddle_tpu.dataset import image as jimage
from paddle_tpu.reader import creator as jcreator
from paddle_tpu.utils import retry as jretry

import paddle_tpu_torch.dataset as tdataset
from paddle_tpu_torch.dataset import common as tcommon
from paddle_tpu_torch.dataset import image as timage
from paddle_tpu_torch.utils import retry as tretry


def _same_sample(a, b):
    if isinstance(b, (tuple, list)):
        assert isinstance(a, (tuple, list)) and len(a) == len(b)
        for x, y in zip(a, b):
            _same_sample(x, y)
        return
    if isinstance(b, np.ndarray) or isinstance(a, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
        return
    assert type(a) is type(b) and a == b


@pytest.mark.parametrize('which', [
    ('mq2007', 'train', dict(format='pairwise')),
    ('mq2007', 'test', dict(format='pairwise')),
    ('mq2007', 'train', dict(format='pointwise')),
    ('sentiment', 'train', {}), ('sentiment', 'test', {}),
    ('voc2012', 'train', {}), ('voc2012', 'test', {}),
    ('voc2012', 'val', {})])
def test_the_new_datasets_are_the_jax_samples(which):
    mod, split, kw = which
    got = list(getattr(getattr(tdataset, mod), split)(**kw)())
    want = list(getattr(getattr(jdataset, mod), split)(**kw)())
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        _same_sample(a, b)
    if mod == 'sentiment':
        assert tdataset.sentiment.get_word_dict() == \
            jdataset.sentiment.get_word_dict()


CONVERTS = {
    'cifar': ['cifar_train100', 'cifar_test100', 'cifar_train10',
              'cifar_test10'],
    'conll05': ['conl105_test'],
    'imdb': ['imdb_train', 'imdb_test'],
    'imikolov': ['imikolov_train', 'imikolov_test'],
    'mnist': ['minist_train', 'minist_test'],
    'movielens': ['movielens_train', 'movielens_test'],
    'sentiment': ['sentiment_train', 'sentiment_test'],
    'uci_housing': ['uci_housing_train', 'uci_houseing_test'],
    'wmt14': ['wmt14_train', 'wmt14_test'],
    'wmt16': ['wmt16_train', 'wmt16_test', 'wmt16_validation'],
}


def _port_reader(mod, prefix):
    """The port's reader behind one convert prefix."""
    m = getattr(tdataset, mod)
    split = prefix.split('_')[-1]
    if mod == 'cifar':
        return getattr(m, split)()
    if mod == 'imdb':
        return getattr(m, split)(m.word_dict())
    if mod == 'imikolov':
        return getattr(m, split)(m.build_dict(), 5)
    if mod == 'wmt14':
        return getattr(m, split)(30000)
    return getattr(m, split)()


@pytest.mark.parametrize('mod', sorted(CONVERTS))
def test_convert_shards_read_back_through_jax_creator(tmp_path, mod):
    getattr(tdataset, mod).convert(str(tmp_path))
    names = sorted(os.listdir(str(tmp_path)))
    for prefix in CONVERTS[mod]:
        shards = [n for n in names if n.rsplit('-', 1)[0] == prefix]
        assert shards and shards[0] == prefix + '-00000', (prefix, names)
        want = list(_port_reader(mod, prefix)())
        paths = [str(tmp_path / n) for n in shards]
        got = [pickle.loads(p) for p in jcreator.recordio(paths)()]
        assert len(got) == len(want)
        assert len(shards) == -(-len(want) // 1000)
        for a, b in zip(got, want):
            _same_sample(a, b)
    assert len(names) == sum(-(-len(list(_port_reader(mod, p)())) // 1000)
                             for p in CONVERTS[mod])


def test_common_convert_is_the_jax_convert(tmp_path):
    def reader():
        for i in range(23):
            yield i, np.arange(i, dtype='int64')

    os.makedirs(str(tmp_path / 't'))
    os.makedirs(str(tmp_path / 'j'))
    assert tcommon.convert(str(tmp_path / 't'), reader, 10, 'toy') == 23
    assert jcommon.convert(str(tmp_path / 'j'), reader, 10, 'toy') == 23
    for i in range(3):
        with open(str(tmp_path / 't' / ('toy-%05d' % i)), 'rb') as f, \
                open(str(tmp_path / 'j' / ('toy-%05d' % i)), 'rb') as g:
            assert f.read() == g.read()
    with pytest.raises(ValueError):
        tcommon.convert(str(tmp_path), reader, 0, 'toy')


def _ints(n):
    def r():
        for i in range(n):
            yield (i, i * i)
    return r


def test_split_and_cluster_files_reader(tmp_path):
    for common, d in ((tcommon, 't'), (jcommon, 'j')):
        os.makedirs(str(tmp_path / d))
        assert common.split(_ints(25), line_count=10,
                            suffix=str(tmp_path / d / 'part-%05d.pickle')) \
            == 3
    for i in range(3):
        with open(str(tmp_path / 't' / ('part-%05d.pickle' % i)), 'rb') as f, \
                open(str(tmp_path / 'j' / ('part-%05d.pickle' % i)),
                     'rb') as g:
            assert f.read() == g.read()
    seen = []
    for tid in range(2):
        r = tcommon.cluster_files_reader(str(tmp_path / 't' / 'part-*'),
                                         trainer_count=2, trainer_id=tid)
        jr = jcommon.cluster_files_reader(str(tmp_path / 't' / 'part-*'),
                                          trainer_count=2, trainer_id=tid)
        seen.append(list(r()))
        assert seen[-1] == list(jr())
    assert sorted(s[0] for s in seen[0] + seen[1]) == list(range(25))
    assert not {s[0] for s in seen[0]} & {s[0] for s in seen[1]}
    with pytest.raises(TypeError):
        tcommon.split(_ints(3), 2, str(tmp_path / 'x%d'), dumper='no')
    with pytest.raises(TypeError):
        list(tcommon.cluster_files_reader(str(tmp_path / 't' / 'part-*'), 1,
                                          0, loader='no')())


def test_md5file_data_path_and_download(tmp_path, monkeypatch):
    monkeypatch.setattr(tcommon, 'DATA_HOME', str(tmp_path / 'home'))
    payload = b'dataset-bytes'
    md5 = hashlib.md5(payload).hexdigest()
    p = str(tmp_path / 'f.bin')
    with open(p, 'wb') as f:
        f.write(payload)
    assert tcommon.md5file(p) == jcommon.md5file(p) == md5
    assert tcommon.data_path('mod', 'y.bin') == \
        os.path.join(str(tmp_path / 'home'), 'mod', 'y.bin')
    # zero egress: no fetcher, nothing cached -> None and nothing written
    assert tcommon.download('http://x/w.bin', 'mod', md5) is None
    assert os.listdir(str(tmp_path / 'home' / 'mod')) == []
    calls = []

    def flaky(url, dest):
        calls.append(url)
        if len(calls) < 3:
            with open(dest, 'wb') as f:
                f.write(payload[:4])       # a torn transfer
            raise IOError('connection reset')
        with open(dest, 'wb') as f:
            f.write(payload)

    got = tcommon.download('http://x/y.bin', 'mod', md5, fetcher=flaky,
                           _sleep=lambda d: None)
    assert got == tcommon.data_path('mod', 'y.bin') and len(calls) == 3
    with open(got, 'rb') as f:
        assert f.read() == payload
    # cached: no fetch
    assert tcommon.download('http://x/y.bin', 'mod', md5,
                            fetcher=lambda u, d: calls.append(u)) == got
    assert len(calls) == 3

    def corrupt(url, dest):
        with open(dest, 'wb') as f:
            f.write(b'corrupted')

    with pytest.raises(tretry.RetryError):
        tcommon.download('http://x/z.bin', 'mod', md5, fetcher=corrupt,
                         retries=1, _sleep=lambda d: None)
    assert sorted(os.listdir(str(tmp_path / 'home' / 'mod'))) == ['y.bin']
    # the JAX package's download behaves the same
    monkeypatch.setattr(jcommon, 'DATA_HOME', str(tmp_path / 'jhome'))
    with pytest.raises(jretry.RetryError):
        jcommon.download('http://x/z.bin', 'mod', md5, fetcher=corrupt,
                         retries=1, _sleep=lambda d: None)


def test_feature_range_and_fetch_return_none():
    assert tdataset.uci_housing.feature_range([1.0], [0.0]) is None
    assert jdataset.uci_housing.feature_range([1.0], [0.0]) is None
    assert tdataset.wmt16.fetch() is None and jdataset.wmt16.fetch() is None


def _png(arr):
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format='PNG')
    return buf.getvalue()


def test_image_loaders_are_the_jax_loaders(tmp_path):
    arr = (np.random.RandomState(4).rand(20, 30, 3) * 255).astype('uint8')
    data = _png(arr)
    p = str(tmp_path / 'x.png')
    with open(p, 'wb') as f:
        f.write(data)
    assert timage.load_image_bytes(data).tobytes() == arr.tobytes()
    for color in (True, False):
        got = timage.load_image(p, is_color=color)
        want = jimage.load_image(p, is_color=color)
        assert got.shape == want.shape and got.tobytes() == want.tobytes()
    assert timage.load_image(p, is_color=False).shape == (20, 30)
    got = timage.load_and_transform(p, 16, 12, False, mean=[1.0, 2.0, 3.0])
    want = jimage.load_and_transform(p, 16, 12, False, mean=[1.0, 2.0, 3.0])
    assert got.shape == (3, 12, 12) and got.tobytes() == want.tobytes()


def test_batch_images_from_tar_is_the_jax_one(tmp_path):
    r = np.random.RandomState(6)
    img2label = {}
    for d in ('t', 'j'):
        os.makedirs(str(tmp_path / d))
    for d in ('t', 'j'):
        with tarfile.open(str(tmp_path / d / 'data.tar'), 'w') as tf:
            for i in range(5):
                data = _png((np.random.RandomState(i).rand(8, 8, 3)
                             * 255).astype('uint8'))
                info = tarfile.TarInfo('img_%d.png' % i)
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))
                img2label['img_%d.png' % i] = int(r.randint(0, 3))
    metas = [m.batch_images_from_tar(str(tmp_path / d / 'data.tar'), 'toy',
                                     img2label, num_per_batch=2)
             for m, d in ((timage, 't'), (jimage, 'j'))]
    files = [open(m).read().splitlines() for m in metas]
    assert [os.path.basename(f) for f in files[0]] == \
        [os.path.basename(f) for f in files[1]] == \
        ['batch_0.npz', 'batch_1.npz', 'batch_2.npz']
    for ft, fj in zip(*files):
        zt, zj = np.load(ft, allow_pickle=True), np.load(fj, allow_pickle=True)
        assert list(zt['data']) == list(zj['data'])
        assert zt['label'].tobytes() == zj['label'].tobytes()
    assert timage.load_image_bytes(
        np.load(files[0][0], allow_pickle=True)['data'][0]).shape == (8, 8, 3)
    # a second call finds the batches and returns the same meta file
    assert timage.batch_images_from_tar(str(tmp_path / 't' / 'data.tar'),
                                        'toy', img2label) == metas[0]


def test_image_decoders_name_pil_when_it_is_missing(monkeypatch):
    import builtins
    real_import = builtins.__import__

    def no_pil(name, *a, **kw):
        if name == 'PIL' or name.startswith('PIL.'):
            raise ImportError('No module named %r' % name)
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, '__import__', no_pil)
    with pytest.raises(ImportError, match='PIL'):
        timage.load_image_bytes(b'\x89PNG')
    # the array transforms need no PIL
    out = timage.simple_transform_batch(np.zeros((1, 8, 8, 3), 'uint8'), 8,
                                        8, False)
    assert out.shape == (1, 3, 8, 8)
