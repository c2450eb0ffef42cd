"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu.

The JAX package (paddle_tpu) is the reference; this package mirrors its
structure and names, written in PyTorch's idiom, and runs on an NVIDIA
H100. Its hot kernels are hand-written CUDA C++ for Hopper (ops/, csrc/),
each beside a plain torch version used for CPU tensors. It never imports
jax or paddle_tpu.

Entry points run on the card unless the caller asks for the CPU:
Executor() and inference.Predictor(dirname) default to CUDAPlace(0) and
raise when no card is present.
"""
from .version import full_version as __version__  # noqa: F401
from .version import commit as __git_commit__  # noqa: F401
from . import obs  # noqa: F401
from . import fluid  # noqa: F401
from . import ops  # noqa: F401
from . import reader  # noqa: F401
from . import dataset  # noqa: F401
from . import compat  # noqa: F401
from .batch import batch  # noqa: F401

__all__ = ['fluid', 'obs', 'ops', 'reader', 'dataset', 'compat', 'batch',
           'install_as_paddle']


def install_as_paddle():
    """Alias this package as `paddle`, so reference scripts run unmodified
    (`import paddle.fluid as fluid`, `from paddle.fluid.executor import
    Executor`, ...). The JAX :24-82.

    Every `paddle_tpu_torch.*` module already imported is registered under
    the matching `paddle.*` name, and a meta-path finder resolves later
    `paddle.*` imports to the SAME module objects. Without the finder,
    `import paddle.fluid.executor` would load a second copy of executor.py
    through the package's __path__, and isinstance checks across the two
    copies (SeqValue, Variable) would fail.

    Raises RuntimeError if a different module named `paddle` is already
    imported: shadowing it silently would be worse than failing."""
    import importlib
    import importlib.abc
    import importlib.machinery
    import sys

    existing = sys.modules.get('paddle')
    if existing is not None and existing is not sys.modules[__name__]:
        raise RuntimeError(
            'a different `paddle` module is already imported; '
            'install_as_paddle() would shadow it')

    class _AliasLoader(importlib.abc.Loader):
        def __init__(self, module):
            self._module = module

        def create_module(self, spec):
            return self._module

        def exec_module(self, module):
            pass  # already executed under its paddle_tpu_torch.* name

    class _AliasFinder(importlib.abc.MetaPathFinder):
        def find_spec(self, fullname, path=None, target=None):
            if fullname != 'paddle' and not fullname.startswith('paddle.'):
                return None
            real = __name__ + fullname[len('paddle'):]
            try:
                mod = importlib.import_module(real)
            except ImportError:
                return None
            return importlib.machinery.ModuleSpec(
                fullname, _AliasLoader(mod),
                is_package=hasattr(mod, '__path__'))

    for name in list(sys.modules):
        if name == __name__ or name.startswith(__name__ + '.'):
            sys.modules['paddle' + name[len(__name__):]] = sys.modules[name]
    if not any(getattr(f, '_paddle_tpu_torch_alias', False)
               for f in sys.meta_path):
        finder = _AliasFinder()
        finder._paddle_tpu_torch_alias = True
        sys.meta_path.insert(0, finder)
