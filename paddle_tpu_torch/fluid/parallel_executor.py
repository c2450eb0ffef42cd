"""ParallelExecutor: data-parallel training over the ranks of the process
group.

Parity: reference python/paddle/fluid/parallel_executor.py (the multi-GPU
NCCL executor) and the JAX package's fluid/parallel_executor.py (:1-181), a
deprecated shim that emits the mesh annotations of `Program.set_mesh` for
each `run` call. Here too: the program runs through the plain Executor's
mesh path (fluid/mesh_step.py) on a dp mesh of the world's size.

use_cuda=None or True runs on this rank's card with NCCL (raising without a
card), use_cuda=False on the CPU with gloo. Without a process group the
constructor joins a one-rank group (parallel.init_distributed), so the step
still runs its collectives. `BuildStrategy.ReduceStrategy.Reduce` becomes
ZeRO-3 for the call: each persistable of at least 1024 elements
(parallel.FSDP_MIN_SIZE) is held as this rank's block of its first dim the
world divides.
"""
import warnings

import torch

from .. import parallel
from . import core
from .executor import Executor, global_scope
from .framework import default_main_program

__all__ = ['ParallelExecutor', 'ExecutionStrategy', 'BuildStrategy']

_warned = [False]


def _warn_deprecated():
    if _warned[0]:
        return
    _warned[0] = True
    warnings.warn(
        "ParallelExecutor is deprecated: declare the mesh on the Program "
        "instead — program.set_mesh({'dp': N}) (ParamAttr(sharding=...) "
        "for parameter layouts) and run it through the plain "
        "Executor.run/run_bundle/Trainer. See docs/parallel.md and "
        "docs/migration.md.", DeprecationWarning, stacklevel=3)


class ExecutionStrategy(object):
    """Shim of the reference ExecutionStrategy pybind struct."""

    def __init__(self):
        self.num_threads = 0
        self.use_event = True
        self.allow_op_delay = False
        self.num_iteration_per_drop_scope = 1


class BuildStrategy(object):
    """Shim of the reference BuildStrategy pybind struct."""

    class ReduceStrategy(object):
        AllReduce = 0
        Reduce = 1

    class GradientScaleStrategy(object):
        CoeffNumDevice = 0
        One = 1
        Customized = 2

    def __init__(self):
        self.reduce_strategy = BuildStrategy.ReduceStrategy.AllReduce
        self.gradient_scale_strategy = \
            BuildStrategy.GradientScaleStrategy.CoeffNumDevice
        self.debug_graphviz_path = ""


class ParallelExecutor(object):
    """reference parallel_executor.py:ParallelExecutor; see the module
    docstring. dp is the world size; `num_devices`, when given, must equal
    it. `num_trainers` / `trainer_id` are accepted for the reference
    signature: the process group decides the ranks."""

    def __init__(self, use_cuda=None, loss_name=None, main_program=None,
                 share_vars_from=None, exec_strategy=None, build_strategy=None,
                 num_trainers=1, trainer_id=0, scope=None, devices=None,
                 num_devices=None, use_tpu=None, **kwargs):
        _warn_deprecated()
        self._program = main_program or default_main_program()
        self._loss_name = loss_name
        self._scope = scope or global_scope()
        self._build_strategy = build_strategy
        if use_cuda is None:
            use_cuda = True if use_tpu is None else bool(use_tpu)
        backend = 'nccl' if use_cuda else 'gloo'
        info = parallel.init_distributed(backend=backend)
        if info['backend'] != backend:
            raise ValueError(
                'ParallelExecutor(use_cuda=%r) needs a %s process group; '
                'this process joined one with %s'
                % (use_cuda, backend, info['backend']))
        self._ndev = parallel.process_count()
        if num_devices is not None and int(num_devices) != self._ndev:
            if int(num_devices) > self._ndev:
                raise ValueError("num_devices=%d > %d visible devices"
                                 % (num_devices, self._ndev))
            raise ValueError('num_devices=%d: the mesh spans the world of %d '
                             'ranks' % (num_devices, self._ndev))
        self._axes = (('dp', self._ndev),)
        place = core.CUDAPlace(torch.cuda.current_device()) if use_cuda \
            else core.CPUPlace()
        self._exe = Executor(place)
        if share_vars_from is not None:
            self._scope = share_vars_from._scope

    @property
    def device_count(self):
        return self._ndev

    def run(self, fetch_list, feed=None, feed_dict=None, return_numpy=True):
        """reference parallel_executor.py:run. The feed is ONE global batch,
        each rank running its rows; the mesh is armed for this call only."""
        feed = feed if feed is not None else feed_dict or {}
        p = self._program
        bs = self._build_strategy
        prev = (p._mesh_axes, p._mesh_data_axis, p._mesh_fsdp)
        p._mesh_axes = self._axes
        p._mesh_data_axis = 'dp'
        # ReduceStrategy.Reduce is ZeRO-3 for this call (the JAX :119 emits
        # it as annotations): each persistable of at least
        # parallel.FSDP_MIN_SIZE elements not annotated otherwise is held
        # as this rank's block of its first dim the world divides
        p._mesh_fsdp = bs is not None and \
            bs.reduce_strategy == BuildStrategy.ReduceStrategy.Reduce
        try:
            return self._exe.run(p, feed=feed, fetch_list=fetch_list,
                                 scope=self._scope,
                                 return_numpy=return_numpy)
        finally:
            p._mesh_axes, p._mesh_data_axis, p._mesh_fsdp = prev

    def bcast_params(self):
        """Parity shim: every rank initializes its parameters from the same
        seeded startup program, so there is nothing to broadcast."""
        return None
