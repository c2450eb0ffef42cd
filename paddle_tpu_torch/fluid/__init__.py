"""paddle_tpu_torch.fluid — the Fluid API of the PyTorch/CUDA port.

Parity: reference python/paddle/fluid/__init__.py and the JAX package's
paddle_tpu.fluid, reduced to what the port carries so far: the Program
IR, the layer builders of the port's models, nets, LoDTensor (sequence
feeds and fetches), the DataFeeder, the
Executor and its compiled step (step_artifact: one captured CUDA graph per
step signature on the card), the anomaly guard, the NaN/Inf debugger, io,
the training step (backward, optimizer, regularizer, clip), AMP (amp) and
the bf16 inference transpiler (contrib.Float16Transpiler).
"""
from . import core
from . import framework
from .framework import Program, Operator, Parameter, Variable, \
    default_startup_program, default_main_program, program_guard, get_var
from . import lowering
from . import ops_impl  # noqa: F401  (registers every op rule)
from . import passes
from . import step_artifact
from . import amp
from . import debugger
from . import executor
from .executor import Executor, global_scope, scope_guard, Scope, \
    anomaly_guard
from . import layers
from . import initializer
from . import io
from . import backward
from . import regularizer
from . import clip
from . import optimizer
from . import nets
from . import lod_tensor
from .lod_tensor import LoDTensor, LoDTensorArray, create_lod_tensor, \
    create_random_int_lodtensor
from . import data_feeder
from .data_feeder import DataFeeder
from .param_attr import ParamAttr, WeightNormParamAttr
from . import unique_name
from . import contrib
from .core import CPUPlace, CUDAPlace, TPUPlace, CUDAPinnedPlace

Tensor = LoDTensor

__all__ = framework.__all__ + executor.__all__ + [
    'io', 'initializer', 'layers', 'ParamAttr', 'WeightNormParamAttr',
    'unique_name', 'core',
    'backward', 'optimizer', 'regularizer', 'clip', 'nets', 'data_feeder',
    'DataFeeder', 'LoDTensor', 'LoDTensorArray', 'create_lod_tensor',
    'create_random_int_lodtensor', 'debugger', 'step_artifact', 'passes', 'amp', 'contrib',
    'CPUPlace', 'CUDAPlace', 'TPUPlace', 'CUDAPinnedPlace',
]
