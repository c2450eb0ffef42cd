"""Build and bind the port's hand-written CUDA kernels.

Each kernel is one CUDA C++ source under paddle_tpu_torch/csrc/ with a
plain C entry point. At first use it is compiled with nvcc for Hopper
(`sm_90a`) into a shared library under paddle_tpu_torch/build/ (named by
the hash of the source, so an edited source is rebuilt) and loaded with
ctypes. Pointers and the stream cross as c_void_p; every C entry point
returns cudaGetLastError() and the wrapper raises on anything but 0.

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


def nvcc_path():
    """nvcc of the CUDA toolkit PyTorch resolves (CUDA_HOME / CUDA_PATH /
    the conventional install location), else whatever PATH offers."""
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, 'bin', 'nvcc')
        if os.path.exists(cand):
            return cand
    return 'nvcc'


class CudaKernel(object):
    """One hand-written kernel: its source, the C entry point, the ctypes
    signature, and `launches`, a plain count of successful launches (the
    wrapper adds one where it launches the kernel, and nowhere else)."""

    def __init__(self, name, source, entry, argtypes, replaces):
        self.name = name
        self.source = source            # path relative to the package
        self.entry = entry
        self.argtypes = list(argtypes)
        self.replaces = replaces        # the TPU kernel it replaces
        self.launches = 0
        self.build_log = None
        self._fn = None
        self._lock = threading.Lock()
        KERNELS[name] = self

    @property
    def source_path(self):
        return os.path.join(_PKG_DIR, self.source)

    def library_path(self):
        with open(self.source_path, 'rb') as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:12]
        return os.path.join(BUILD_DIR, 'lib%s-%s.so' % (self.name, digest))

    def start_build(self):
        """Start nvcc for this kernel; returns (Popen, tmp path, final
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

    def _load(self):
        with self._lock:
            if self._fn is None:
                started = self.start_build()
                if started is not None:
                    self.finish_build(started)
                lib = ctypes.CDLL(self.library_path())
                fn = getattr(lib, self.entry)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                err = lib.port_cuda_error_string
                err.argtypes = [ctypes.c_int]
                err.restype = ctypes.c_char_p
                self._err = err
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
    """Build every registered kernel, one nvcc process per source, all
    started together. Returns {name: nvcc output} for the kernels built."""
    started = {n: k.start_build() for n, k in KERNELS.items()}
    logs, errors = {}, []
    for n, s in started.items():
        if s is None:
            continue
        try:    # reap every nvcc before reporting any failure
            KERNELS[n].finish_build(s)
        except RuntimeError as e:
            errors.append(str(e))
            continue
        logs[n] = KERNELS[n].build_log
    if errors:
        raise RuntimeError('\n'.join(errors))
    return logs
