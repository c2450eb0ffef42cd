"""Dataset plumbing. Parity: reference python/paddle/dataset/common.py and
the JAX package's dataset/common.py: the cache (DATA_HOME, data_path,
md5file, a zero-egress download), the synthetic generator's seed
(synthetic_rng, the JAX :75-78), sharding a reader into pickle files and
back (split, cluster_files_reader) and recordio conversion (convert)."""
import hashlib
import os

import numpy as np

__all__ = ['DATA_HOME', 'data_home', 'download', 'md5file', 'data_path',
           'synthetic_rng', 'split', 'cluster_files_reader', 'convert']

# the port's own cache, apart from the JAX package's ~/.cache/paddle_tpu
DATA_HOME = os.path.expanduser('~/.cache/paddle_tpu_torch/dataset')


def must_mkdirs(path):
    os.makedirs(path, exist_ok=True)


def data_home():
    """DATA_HOME, created on first use."""
    must_mkdirs(DATA_HOME)
    return DATA_HOME


def md5file(fname):
    hash_md5 = hashlib.md5()
    with open(fname, "rb") as f:
        for chunk in iter(lambda: f.read(4096), b""):
            hash_md5.update(chunk)
    return hash_md5.hexdigest()


def data_path(module_name, filename):
    return os.path.join(DATA_HOME, module_name, filename)


def download(url, module_name, md5sum, save_name=None, fetcher=None,
             retries=3, deadline=None, _sleep=None):
    """Zero-egress by default: with no `fetcher`, returns the cache path
    if the file was put there beforehand, else None (the datasets are
    synthetic).

    fetcher(url, dest_path): an optional transport hook (an environment
    that is allowed egress, or a test harness). It runs under
    utils.retry.retry_call (exponential backoff with jitter, bounded
    attempts, an optional wall-clock deadline), and each attempt's file is
    md5-checked before the atomic rename into the cache, so a torn or
    corrupted transfer is retried instead of poisoning the cache."""
    dirname = os.path.join(data_home(), module_name)
    must_mkdirs(dirname)
    filename = os.path.join(dirname, save_name or url.split('/')[-1])
    if os.path.exists(filename):
        return filename
    if fetcher is None:
        return None

    from ..utils.retry import retry_call

    def attempt():
        tmp = filename + '.part'
        try:
            fetcher(url, tmp)
            if md5sum is not None and md5file(tmp) != md5sum:
                raise IOError(
                    'download %r: md5 mismatch (corrupted transfer)' % url)
            os.replace(tmp, filename)  # atomic: the cache never holds a tear
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        return filename

    import time
    return retry_call(attempt, retries=retries, deadline=deadline,
                      retry_on=(IOError, OSError),
                      sleep=time.sleep if _sleep is None else _sleep,
                      describe='download %r' % url)


def synthetic_rng(tag, seed=1234):
    """Deterministic per-dataset RNG for synthetic fallbacks."""
    h = int(hashlib.md5(tag.encode()).hexdigest()[:8], 16)
    return np.random.RandomState((seed + h) % (2 ** 31))


def split(reader, line_count, suffix="%05d.pickle", dumper=None):
    """Shard a reader's samples into files of line_count samples each
    (reference common.py:split; binary pickle by default); returns the
    number of files."""
    import pickle
    if dumper is None:
        dumper = pickle.dump
    if not callable(dumper):
        raise TypeError("dumper should be callable.")
    lines = []
    indx_f = 0
    for d in reader():
        lines.append(d)
        if len(lines) == line_count:
            with open(suffix % indx_f, "wb") as f:
                dumper(lines, f)
            lines = []
            indx_f += 1
    if lines:
        with open(suffix % indx_f, "wb") as f:
            dumper(lines, f)
    return indx_f + (1 if lines else 0)


def cluster_files_reader(files_pattern, trainer_count, trainer_id,
                         loader=None):
    """Round-robin the files produced by split() across trainers
    (reference common.py:cluster_files_reader)."""
    import glob
    import pickle
    if loader is None:
        loader = pickle.load

    def reader():
        if not callable(loader):
            raise TypeError("loader should be callable.")
        file_list = sorted(glob.glob(files_pattern))
        for idx, fn in enumerate(file_list):
            if idx % trainer_count == trainer_id:
                with open(fn, "rb") as f:
                    for line in loader(f):
                        yield line

    return reader


def convert(output_path, reader, line_count, name_prefix):
    """Serialize a reader into sharded recordio files
    `<output_path>/<name_prefix>-00000...` of line_count samples each, one
    pickled sample a record (reference common.py:convert); returns the
    number of samples written."""
    import pickle
    from ..reader.recordio import RecordIOWriter
    if line_count < 1:
        raise ValueError("line_count must be >= 1, got %r" % (line_count,))
    indx_f = 0
    written = 0

    def write_shard(idx, lines):
        filename = "%s/%s-%05d" % (output_path, name_prefix, idx)
        with RecordIOWriter(filename) as w:
            for l in lines:
                w.write(pickle.dumps(l, pickle.HIGHEST_PROTOCOL))

    lines = []
    for d in reader():
        lines.append(d)
        if len(lines) == line_count:
            write_shard(indx_f, lines)
            written += len(lines)
            lines = []
            indx_f += 1
    if lines:
        write_shard(indx_f, lines)
        written += len(lines)
    return written
