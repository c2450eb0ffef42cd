"""paddle_tpu_torch.fluid — the Fluid API of the PyTorch/CUDA port.

Parity: reference python/paddle/fluid/__init__.py and the JAX package's
paddle_tpu.fluid, reduced to what the port carries so far: the Program
IR, the layer builders of the port's models, nets, LoDTensor (sequence
feeds and fetches), the DataFeeder, the
Executor and its compiled step (step_artifact: one captured CUDA graph per
step signature on the card), the anomaly guard, the NaN/Inf debugger, io
(with the dense failure-recovery checkpoints), the training step
(backward, optimizer, regularizer, clip), AMP (amp), the bf16 inference
transpiler (contrib.Float16Transpiler), and the high-level API: Trainer
(events, CheckpointConfig, preemption and resume), Inferencer, and the
host-side metrics, average and evaluator; the pass pipeline (passes:
PADDLE_TPU_OPT, int8 weight quantization), the dataflow analysis it
builds on, and the InferenceTranspiler and memory_optimize shims; the
aux modules annotations, concurrency (host-side channels), default
scope functions, graphviz and net_drawer.
"""
from . import core
from . import framework
from .framework import Program, Operator, Parameter, Variable, Block, \
    default_startup_program, default_main_program, program_guard, \
    name_scope, get_var, grad_var_name, normalize_sharding
from . import lowering
from . import ops_impl  # noqa: F401  (registers every op rule)
from . import passes
from . import analysis
from . import step_artifact
from . import amp
from . import debugger
from . import executor
from .executor import Executor, global_scope, scope_guard, _switch_scope, \
    Scope, StepHandle, FetchHandle, anomaly_guard
from . import layers
from . import initializer
from . import io
from . import backward
from .backward import append_backward
from . import regularizer
from . import clip
from .clip import ErrorClipByValue, GradientClipByValue, GradientClipByNorm, \
    GradientClipByGlobalNorm
from . import optimizer
from . import nets
from . import lod_tensor
from .lod_tensor import LoDTensor, LoDTensorArray, create_lod_tensor, \
    create_random_int_lodtensor
from . import data_feeder
from .data_feeder import DataFeeder
from .param_attr import ParamAttr, WeightNormParamAttr
# re-exported by name, as the JAX fluid/__init__.py:33 does; the patch
# itself is applied as math_op_patch's import side effect
from .layers.math_op_patch import monkey_patch_variable
from . import unique_name
from . import contrib
from . import evaluator
from . import metrics
from . import average
from . import trainer
from .trainer import Trainer, BeginEpochEvent, EndEpochEvent, \
    BeginStepEvent, EndStepEvent, CheckpointConfig
from . import inferencer
from .inferencer import Inferencer
from .core import CPUPlace, CUDAPlace, TPUPlace, CUDAPinnedPlace
from . import transpiler
from .transpiler import InferenceTranspiler, memory_optimize, \
    release_memory
from .analysis import ProgramVerifyError
from . import annotations
from . import concurrency
from . import default_scope_funcs
from . import graphviz
from . import net_drawer
from . import recordio_writer
from .concurrency import (Go, make_channel, channel_send, channel_recv,
                          channel_close, Select)

Tensor = LoDTensor

__all__ = framework.__all__ + executor.__all__ + trainer.__all__ + \
    inferencer.__all__ + transpiler.__all__ + [
    'io', 'initializer', 'layers', 'ParamAttr', 'WeightNormParamAttr',
    'unique_name', 'core',
    'backward', 'optimizer', 'regularizer', 'clip', 'nets', 'data_feeder',
    'DataFeeder', 'LoDTensor', 'LoDTensorArray', 'create_lod_tensor',
    'create_random_int_lodtensor', 'debugger', 'step_artifact', 'passes', 'amp', 'contrib',
    'metrics', 'average', 'evaluator', 'trainer', 'inferencer',
    'transpiler', 'analysis', 'ProgramVerifyError', 'CPUPlace', 'CUDAPlace',
    'TPUPlace', 'CUDAPinnedPlace', 'Tensor',
]
