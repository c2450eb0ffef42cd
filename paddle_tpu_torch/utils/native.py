"""The port's native host library: recordio and batched image augmentation.

Two C++ sources under paddle_tpu_torch/csrc/ (the port's own copies of the
JAX package's csrc/recordio.cpp and image_aug.cpp) make one shared library:
the mmap'd recordio scanner, its writer and its prefetch thread (`ptrio_*`),
and the multithreaded simple_transform over a batch
(`ptim_transform_batch`). It is host code: no device kernel is in it.

At first use the host C++ compiler (`g++`) builds it with
CXX_FLAGS into paddle_tpu_torch/build/, named by a hash of the sources, the
compiler and the flags (as ops/_cuda.py names its nvcc builds), writing to a
temporary name and publishing it by an atomic rename, so that concurrent
processes never load a half-written file. The library is loaded with
ctypes.

There is no fallback: a build that fails raises with the compiler's output,
a library that does not load raises, and every caller of this module goes
through the native code. The pure-python RecordIOReader (reader/recordio.py)
and the numpy transform (dataset/image.py) are the plain versions the tests
hold this code against; no code path chooses between them at run time.

    python -c "from paddle_tpu_torch.utils import native; native.load()"

builds it ahead of use.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

__all__ = ['NativeLibrary', 'LIBRARY', 'CXX_FLAGS', 'load',
           'image_transform_batch', 'recordio_iter', 'recordio_prefetch_iter',
           'NativeRecordWriter']

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG_DIR, 'build')
SOURCES = ('csrc/recordio.cpp', 'csrc/image_aug.cpp')
# the JAX package's csrc/Makefile flags
CXX_FLAGS = ('-O2', '-std=c++17', '-fPIC', '-Wall', '-shared')
LD_FLAGS = ('-lpthread',)
_CORRUPT = ('corrupt record file (checksum mismatch or truncation) in %s')


def cxx_path():
    """The host C++ compiler, g++ on PATH. Raises when there is none."""
    cxx = shutil.which('g++')
    if not cxx:
        raise RuntimeError('no host C++ compiler: put g++ on PATH to build '
                           'the native host library (%s)'
                           % ', '.join(SOURCES))
    return cxx


class NativeLibrary(object):
    """C++ sources (relative to `root`) and the one shared library the host
    compiler builds from them into `build_dir`."""

    def __init__(self, sources=SOURCES, root=_PKG_DIR, build_dir=BUILD_DIR):
        self.sources = tuple(sources)
        self.root = root
        self.build_dir = build_dir
        self.build_log = None
        self._lib = None
        self._lock = threading.Lock()

    def source_paths(self):
        return [os.path.join(self.root, s) for s in self.sources]

    def library_path(self):
        """The build's path, named by a hash of the sources' text, the
        compiler and the flags: an edited source, another compiler or
        another flag builds anew."""
        h = hashlib.sha256()
        for path in self.source_paths():
            with open(path, 'rb') as f:
                text = f.read()
            h.update(b'%s %d\n' % (os.path.basename(path).encode(),
                                     len(text)))
            h.update(text)
        h.update(' '.join((cxx_path(),) + CXX_FLAGS + LD_FLAGS).encode())
        return os.path.join(self.build_dir, 'libpaddle_tpu_torch_native-%s.so'
                            % h.hexdigest()[:12])

    def build(self):
        """Compile the library unless it is built; returns its path.
        Raises RuntimeError with the compiler's output on failure."""
        out = self.library_path()
        if os.path.exists(out):
            return out
        os.makedirs(self.build_dir, exist_ok=True)
        tmp = '%s.%d.%d.tmp' % (out, os.getpid(), threading.get_ident())
        cmd = [cxx_path()] + list(CXX_FLAGS) + ['-o', tmp] + \
            self.source_paths() + list(LD_FLAGS)
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        self.build_log = proc.stdout
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise RuntimeError('the host C++ compiler failed (rc %d) to '
                               'build %s:\n$ %s\n%s'
                               % (proc.returncode, ', '.join(self.sources),
                                  ' '.join(cmd), proc.stdout))
        os.replace(tmp, out)
        return out

    def load(self):
        """The loaded library, built first if needed (once per process)."""
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(self.build())
                _bind(lib)
                self._lib = lib
            return self._lib


def _bind(lib):
    lib.ptrio_open.restype = ctypes.c_void_p
    lib.ptrio_open.argtypes = [ctypes.c_char_p]
    lib.ptrio_next.restype = ctypes.c_ssize_t
    lib.ptrio_next.argtypes = [ctypes.c_void_p,
                               ctypes.POINTER(ctypes.c_char_p)]
    lib.ptrio_close.argtypes = [ctypes.c_void_p]
    lib.ptrio_writer_open.restype = ctypes.c_void_p
    lib.ptrio_writer_open.argtypes = [ctypes.c_char_p]
    lib.ptrio_writer_write.restype = ctypes.c_int
    lib.ptrio_writer_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                       ctypes.c_uint64]
    lib.ptrio_writer_close.argtypes = [ctypes.c_void_p]
    lib.ptrio_prefetch_open.restype = ctypes.c_void_p
    lib.ptrio_prefetch_open.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
    lib.ptrio_prefetch_next.restype = ctypes.c_ssize_t
    lib.ptrio_prefetch_next.argtypes = [ctypes.c_void_p,
                                        ctypes.POINTER(ctypes.c_char_p)]
    lib.ptrio_prefetch_close.argtypes = [ctypes.c_void_p]
    lib.ptim_transform_batch.restype = ctypes.c_int
    lib.ptim_transform_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64, ctypes.c_void_p]


LIBRARY = NativeLibrary()


def load():
    """The port's native host library, built at first use."""
    return LIBRARY.load()


def transform_mean(mean, c, crop_size):
    """`mean` as the contiguous float32 vector the routine takes: None, or
    1, c or c * crop_size**2 values (a scalar, one a channel, or a CHW
    mean image). Raises on any other size."""
    if mean is None:
        return None
    m = np.ascontiguousarray(mean, dtype=np.float32).reshape(-1)
    if m.shape[0] not in (1, c, c * crop_size * crop_size):
        raise ValueError('mean of %d values: the transform takes 1, c=%d or '
                         'c*crop*crop=%d' % (m.shape[0], c,
                                             c * crop_size * crop_size))
    return m


def image_transform_batch(images, resize_size, crop_size, is_train,
                          mean=None, seed=0):
    """The multithreaded C++ simple_transform (csrc/image_aug.cpp) over a
    same-sized [n, h, w, c] uint8 batch: [n, c, crop, crop] float32.
    Image i of a train batch draws its crop and flip from its own
    xorshift64* stream of (seed, i)."""
    lib = load()
    images = np.ascontiguousarray(images, dtype=np.uint8)
    if images.ndim != 4:
        raise ValueError('expected an [n, h, w, c] uint8 batch, got %s'
                         % (images.shape,))
    n, h, w, c = images.shape
    m = transform_mean(mean, c, crop_size)
    out = np.empty((n, c, crop_size, crop_size), np.float32)
    rc = lib.ptim_transform_batch(
        images.ctypes.data_as(ctypes.c_void_p), n, h, w, c,
        int(resize_size), int(crop_size), int(bool(is_train)),
        None if m is None else m.ctypes.data_as(ctypes.c_void_p),
        0 if m is None else m.shape[0], int(seed) & 0xFFFFFFFFFFFFFFFF,
        out.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise ValueError('ptim_transform_batch rejected the arguments: n %d, '
                         'h %d, w %d, c %d, resize %d, crop %d'
                         % (n, h, w, c, resize_size, crop_size))
    return out


def _records(path, open_fn, next_fn, close_fn, *open_args):
    lib = load()
    h = getattr(lib, open_fn)(path.encode(), *open_args)
    if not h:
        raise IOError('cannot open %s as a recordio file (missing, '
                                 'shorter than the magic, or another '
                                 'format)' % path)
    nxt = getattr(lib, next_fn)
    try:
        while True:
            buf = ctypes.c_char_p()
            n = nxt(h, ctypes.byref(buf))
            if n == -2:
                raise IOError(_CORRUPT % path)
            if n < 0:
                return
            yield ctypes.string_at(buf, n)
    finally:
        getattr(lib, close_fn)(h)


def recordio_iter(path):
    """The record payloads of `path`, scanned by the mmap'd C++ parser."""
    return _records(path, 'ptrio_open', 'ptrio_next', 'ptrio_close')


def recordio_prefetch_iter(path, depth=4):
    """The record payloads of `path`, staged `depth` ahead by the C++
    background thread."""
    return _records(path, 'ptrio_prefetch_open', 'ptrio_prefetch_next',
                    'ptrio_prefetch_close', int(depth))


class NativeRecordWriter(object):
    """Streaming record writer through the C ABI (crc32 in C++)."""

    def __init__(self, path):
        self._lib = load()
        self._h = self._lib.ptrio_writer_open(path.encode())
        if not self._h:
            raise IOError('cannot open %s for writing' % path)

    def write(self, payload):
        if self._lib.ptrio_writer_write(self._h, payload, len(payload)) != 0:
            raise IOError('short write')

    def close(self):
        if self._h:
            self._lib.ptrio_writer_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
