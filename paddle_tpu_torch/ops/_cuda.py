"""Build and bind the port's hand-written CUDA kernels.

Each CUDA C++ source under paddle_tpu_torch/csrc/ exports one or more plain
C entry points. At first use a source is compiled once with nvcc for Hopper
(`sm_90a`) into one shared library under paddle_tpu_torch/build/ (named by
the source and the hash of its text, so an edited source is rebuilt) and
loaded with ctypes; every kernel registered on that source binds its own
entry point from the one library. Pointers and the stream cross as
c_void_p; every C entry point returns cudaGetLastError() and the wrapper
raises on anything but 0.

There is no fallback: a kernel that does not build or does not launch
raises. Callers pick the plain torch version only for tensors that lie on
the CPU (or on the meta device during shape inference).
"""
import ctypes
import hashlib
import os
import subprocess
import threading

__all__ = ['CudaKernel', 'KERNELS', 'build_all', 'nvcc_path']

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, 'csrc')
BUILD_DIR = os.path.join(_PKG_DIR, 'build')

NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

# every kernel of the port, by name (chip_smoke.py walks this)
KERNELS = {}
# one _Library per CUDA source, shared by the kernels it exports
_LIBRARIES = {}


def nvcc_path():
    """nvcc of the CUDA toolkit PyTorch resolves (CUDA_HOME / CUDA_PATH /
    the conventional install location), else whatever PATH offers."""
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, 'bin', 'nvcc')
        if os.path.exists(cand):
            return cand
    return 'nvcc'


class _Library(object):
    """One CUDA source and the shared library nvcc builds from it."""

    def __init__(self, source):
        self.source = source            # path relative to the package
        self.build_log = None
        self._lib = None
        self._lock = threading.Lock()

    @property
    def source_path(self):
        return os.path.join(_PKG_DIR, self.source)

    def library_path(self):
        with open(self.source_path, 'rb') as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:12]
        stem = os.path.splitext(os.path.basename(self.source))[0]
        return os.path.join(BUILD_DIR, 'lib%s-%s.so' % (stem, digest))

    def start_build(self):
        """Start nvcc for this source; returns (Popen, tmp path, final
        path), or None when the library is already built."""
        out = self.library_path()
        if os.path.exists(out):
            return None
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = '%s.%d.tmp' % (out, os.getpid())
        cmd = [nvcc_path()] + list(NVCC_FLAGS) + [
            '-I', CSRC_DIR, '-o', tmp, self.source_path]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        return proc, tmp, out

    def finish_build(self, started):
        proc, tmp, out = started
        log, _ = proc.communicate()
        self.build_log = log
        if proc.returncode != 0:
            raise RuntimeError('nvcc failed (rc %d) for %s:\n%s'
                               % (proc.returncode, self.source, log))
        os.replace(tmp, out)

    def load(self):
        """The loaded library, built first if needed (once per process)."""
        with self._lock:
            if self._lib is None:
                started = self.start_build()
                if started is not None:
                    self.finish_build(started)
                lib = ctypes.CDLL(self.library_path())
                lib.port_cuda_error_string.argtypes = [ctypes.c_int]
                lib.port_cuda_error_string.restype = ctypes.c_char_p
                self._lib = lib
            return self._lib


class CudaKernel(object):
    """One hand-written kernel: its source, the C entry point, the ctypes
    signature, and `launches`, a plain count of successful launches (the
    wrapper adds one where it launches the kernel, and nowhere else).
    Kernels that name the same source share one build."""

    def __init__(self, name, source, entry, argtypes, replaces):
        self.name = name
        self.source = source            # path relative to the package
        self.entry = entry
        self.argtypes = list(argtypes)
        self.replaces = replaces        # the TPU kernel it replaces
        self.launches = 0
        self.library = _LIBRARIES.setdefault(source, _Library(source))
        self._fn = None
        self._lock = threading.Lock()
        KERNELS[name] = self

    def _load(self):
        with self._lock:
            if self._fn is None:
                lib = self.library.load()
                fn = getattr(lib, self.entry)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                self._err = lib.port_cuda_error_string
                self._fn = fn
            return self._fn

    def launch(self, *args):
        """Call the C entry point; raise on a non-zero cudaError_t, count
        the launch otherwise."""
        rc = self._load()(*args)
        if rc != 0:
            raise RuntimeError('%s: CUDA error %d (%s)' % (
                self.name, rc, self._err(rc).decode()))
        with self._lock:
            self.launches += 1


def build_all():
    """Build every source that a registered kernel names, one nvcc process
    per source, all started together. Returns {source: nvcc output} for
    the sources built."""
    libs = sorted({k.library.source: k.library
                   for k in KERNELS.values()}.items())
    started = [(lib, lib.start_build()) for _, lib in libs]
    logs, errors = {}, []
    for lib, s in started:
        if s is None:
            continue
        try:    # reap every nvcc before reporting any failure
            lib.finish_build(s)
        except RuntimeError as e:
            errors.append(str(e))
            continue
        logs[lib.source] = lib.build_log
    if errors:
        raise RuntimeError('\n'.join(errors))
    return logs
