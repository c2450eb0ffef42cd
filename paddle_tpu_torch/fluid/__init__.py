"""paddle_tpu_torch.fluid — the Fluid API of the PyTorch/CUDA port.

Parity: reference python/paddle/fluid/__init__.py and the JAX package's
paddle_tpu.fluid, reduced to what the port carries so far: the Program
IR, the layer builders of the Transformer, the eager Executor, io, and the
training step (backward, optimizer, regularizer, clip).
"""
from . import core
from . import framework
from .framework import Program, Operator, Parameter, Variable, \
    default_startup_program, default_main_program, program_guard, get_var
from . import lowering
from . import ops_impl  # noqa: F401  (registers every op rule)
from . import executor
from .executor import Executor, global_scope, scope_guard, Scope
from . import layers
from . import initializer
from . import io
from . import backward
from . import regularizer
from . import clip
from . import optimizer
from .param_attr import ParamAttr
from . import unique_name
from .core import CPUPlace, CUDAPlace, TPUPlace, CUDAPinnedPlace

__all__ = framework.__all__ + executor.__all__ + [
    'io', 'initializer', 'layers', 'ParamAttr', 'unique_name', 'core',
    'backward', 'optimizer', 'regularizer', 'clip',
    'CPUPlace', 'CUDAPlace', 'TPUPlace', 'CUDAPinnedPlace',
]
