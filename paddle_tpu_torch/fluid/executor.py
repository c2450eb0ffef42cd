"""Executor: runs a Program as an eager op walk on one torch device.

Parity: reference python/paddle/fluid/executor.py:256 and the JAX
package's fluid/executor.py. The JAX Executor lowers a whole Program into
one jitted XLA step; here each op's rule (ops_impl/) runs eagerly on the
executor's device, in program order, and the CUDA kernels of ops/ launch
from inside those rules. A program that writes no persistable (inference)
runs under torch.inference_mode(); one that does (startup, training) under
torch.no_grad(), so the scope never holds inference tensors, which autograd
could not save.

A program with an `autodiff` op (fluid.backward.append_backward) is a
training step, split at the marker as the JAX package's StepArtifact step
splits it (fluid/step_artifact.py:213-234, dense form): the ops before it
run with the trainable parameters as leaves that require grad,
torch.autograd.grad of the summed loss binds every `<param>@GRAD`, and the
ops after it (clip, regularizers, optimizer updates) run under
torch.no_grad(). Only detached tensors go back to the scope or out as
fetches.

Random ops draw from ONE torch.Generator per Executor, on its device,
re-seeded at every run from Program.random_seed and the run count (the JAX
Executor derives its per-run PRNG key the same way), so a seeded program
gives the same numbers run for run.

The JAX Executor's jit cache, IR passes, mesh placement and run_bundle
have no counterpart yet.
"""
import collections
import contextlib
import threading

import numpy as np
import torch
from torch.profiler import record_function

from .. import obs
from . import core
from .framework import Variable, default_main_program
from .lowering import Ctx, run_block, run_op

__all__ = ['Executor', 'Scope', 'global_scope', 'scope_guard']


class Scope(object):
    """name -> tensor store, optionally chained to a parent scope
    (reference paddle/fluid/framework/scope.h: kid scopes fall back to the
    parent on lookup; writes stay local)."""

    def __init__(self, parent=None):
        self.vars = collections.OrderedDict()
        self.parent = parent

    def new_scope(self):
        return Scope(parent=self)

    def _chain_get(self, name, default=None):
        s = self
        while s is not None:
            if name in s.vars:
                return s.vars[name]
            s = s.parent
        return default

    def _chain_set(self, name, value):
        """Update the scope that OWNS `name`; new names are created
        locally."""
        s = self
        while s is not None:
            if name in s.vars:
                s.vars[name] = value
                return
            s = s.parent
        self.vars[name] = value

    def __contains__(self, name):
        if name in self.vars:
            return True
        return self.parent is not None and name in self.parent

    def load_numpy(self, arrays, place):
        """Carry weights in: put every {name: ndarray} entry into this
        scope as a tensor on `place`'s device (e.g. the JAX package's
        parameters, read from its scope or its __params__.npz)."""
        device = place.torch_device()
        for name, a in arrays.items():
            self.vars[name] = torch.from_numpy(
                np.array(a, copy=True)).to(device)

    def to_numpy(self, names=None):
        """{name: ndarray} of the named (default: all) local variables."""
        names = list(self.vars) if names is None else names
        return {n: self.vars[n].detach().cpu().numpy().copy()
                for n in names}


_global_scope = Scope()


def global_scope():
    return _global_scope


def _switch_scope(scope):
    global _global_scope
    prev = _global_scope
    _global_scope = scope
    return prev


@contextlib.contextmanager
def scope_guard(scope):
    prev = _switch_scope(scope)
    try:
        yield
    finally:
        _switch_scope(prev)


def _as_fetch_name(f):
    return f.name if isinstance(f, Variable) else str(f)


class _RunPlan(object):
    """What a run of one program version needs beyond its ops: the
    persistables it may read from the scope, the ones it writes back, and
    the index of its autodiff op (None: it does not differentiate)."""

    def __init__(self, program):
        block = program.global_block()
        persist = {v.name for v in program.list_vars() if v.persistable}
        self.persistables = sorted(persist)
        self.writes = sorted({n for op in block.ops
                              for n in op.output_arg_names if n in persist})
        ad = [i for i, op in enumerate(block.ops) if op.type == 'autodiff']
        if len(ad) > 1:
            raise ValueError('at most one append_backward per program; '
                             'this one has %d autodiff ops' % len(ad))
        self.ad_idx = ad[0] if ad else None


def _run_ops(ops, env, ctx, detach_stop_gradient=False):
    """Run `ops` against env; with detach_stop_gradient, every output var
    marked stop_gradient is detached (the JAX package's _run_ops in grad
    mode, fluid/step_artifact.py:591-596)."""
    for op in ops:
        run_op(op, env, ctx)
        if detach_stop_gradient:
            for vs in op.outputs.values():
                for v in vs:
                    t = env.get(v.name)
                    if v.stop_gradient and isinstance(t, torch.Tensor):
                        env[v.name] = t.detach()


def _train_step(ops, ad_idx, env, ctx):
    """The step of a program with an autodiff op at ad_idx: the eager
    counterpart of StepArtifact's _grad_setup / _make_fwd / _apply_grads
    (fluid/step_artifact.py:412-478) without the sparse taps."""
    ad = ops[ad_idx]
    pnames = [n for n in ad.attrs['param_names'] if n in env]
    gnames = dict(zip(ad.attrs['param_names'], ad.attrs['grad_names']))
    leaves = [env[n].detach().requires_grad_() for n in pnames]
    env.update(zip(pnames, leaves))
    # record_function ranges name the phases in a torch.profiler trace
    # (tools/torch_train_profile.py); without a profiler they cost ~1 us
    with torch.enable_grad():
        with record_function('executor.forward'):
            _run_ops(ops[:ad_idx], env, ctx, detach_stop_gradient=True)
            loss = env[ad.attrs['loss_name']].to(torch.float32).sum()
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    scale = ad.attrs.get('loss_scale', 1.0)
    for n in list(env):
        if isinstance(env[n], torch.Tensor):
            env[n] = env[n].detach()
    for n, leaf, g in zip(pnames, leaves, grads):
        if g is None:          # the loss does not reach this parameter
            g = torch.zeros_like(leaf)
        if scale != 1.0:
            g = g * scale
        env[gnames[n]] = g.to(leaf.dtype)
    with torch.no_grad(), record_function('executor.update'):
        _run_ops(ops[ad_idx + 1:], env, ctx)


class Executor(object):
    """Parity: reference python/paddle/fluid/executor.py:256.

    place: where every tensor of a run lives. None means CUDAPlace(0), and
    constructing an Executor there without a usable card raises — pass
    CPUPlace() to run on the CPU. run() is thread-safe: concurrent calls
    serialize on the executor."""

    def __init__(self, place=None):
        self.place = core.CUDAPlace(0) if place is None else place
        self.device = self.place.torch_device()
        self._generator = torch.Generator(device=self.device)
        self._run_counter = 0
        self._plans = {}
        self._lock = threading.Lock()

    def _plan(self, program):
        key = (program._uid, program._version)
        plan = self._plans.get(key)
        if plan is None:
            plan = self._plans[key] = _RunPlan(program)
        return plan

    def _feed_tensor(self, val, var):
        if isinstance(val, torch.Tensor):
            t = val
        else:
            a = np.asarray(val)
            if var is not None and var.dtype != 'bfloat16' \
                    and a.dtype != np.dtype(var.dtype):
                a = a.astype(var.dtype)
            if not (a.flags.c_contiguous and a.flags.writeable):
                a = np.array(a, copy=True, order='C')
            t = torch.from_numpy(a)
        if var is not None:
            t = t.to(core.torch_dtype(var.dtype))
        return t.to(self.device)

    def run(self, program=None, feed=None, fetch_list=None,
            feed_var_name='feed', fetch_var_name='fetch', scope=None,
            return_numpy=True):
        """Run `program` once: feeds in, fetches out (numpy arrays, or the
        device tensors with return_numpy=False). Persistables the program
        writes (startup initializers) land in `scope`."""
        if program is None:
            program = default_main_program()
        feed = feed or {}
        fetch_list = fetch_list or []
        if scope is None:
            scope = global_scope()
        block = program.global_block()
        with obs.span('executor.step'), self._lock:
            plan = self._plan(program)
            self._run_counter += 1
            self._generator.manual_seed(
                ((program.random_seed or 0) * 2654435761
                 + self._run_counter) % (1 << 63))
            env = {}
            for name in plan.persistables:
                val = scope._chain_get(name)
                if val is not None:
                    env[name] = val
            for name, val in feed.items():
                env[name] = self._feed_tensor(val, block.vars.get(name))
            ctx = Ctx(self.device, self._generator)
            if plan.ad_idx is not None:
                _train_step(block.ops, plan.ad_idx, env, ctx)
            else:
                mode = torch.no_grad() if plan.writes \
                    else torch.inference_mode()
                with mode:
                    run_block(block, env, ctx)
            for name in plan.writes:
                if name in env:
                    scope._chain_set(name, env[name])
            fetches = [env[_as_fetch_name(f)] for f in fetch_list]
            if not return_numpy:
                return fetches
            with obs.span('executor.fetch'):
                return [self._to_numpy(t) for t in fetches]

    @staticmethod
    def _to_numpy(t):
        a = t.detach().cpu().numpy()
        # a CPU tensor's numpy view would alias scope or cached state
        return a.copy() if t.device.type == 'cpu' else a

    def close(self):
        pass
