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

An is_sparse embedding table that qualifies (the plan of
_sparse_embedding_plan, the JAX StepArtifact's :321-406, unsharded case)
is not a leaf: each of its lookups gets a zero tap that requires grad,
added to the lookup's output, and `W@GRAD` is bound to a
lowering.SparseRows of the lookups' ids and the taps' gradients (JAX
_grad_setup / _run_ops / _apply_grads, :412-501), so the vocab-sized
dense gradient never exists.

Random ops draw from ONE torch.Generator per Executor, on its device,
re-seeded at every run from Program.random_seed and the run count (the JAX
Executor derives its per-run PRNG key the same way), so a seeded program
gives the same numbers run for run.

`acquire_step` pins one feedless state-update program (the decode
engine's step) behind a StepHandle that keeps the written persistables
between calls (JAX executor.py:464, :1568).

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
from .lowering import Ctx, SparseRows, run_block, run_op

__all__ = ['Executor', 'Scope', 'StepHandle', 'global_scope',
           'scope_guard']


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
    """What a run of one program version with one fetch list needs beyond
    its ops: the persistables it may read from the scope, the ones it
    writes back, the index of its autodiff op (None: it does not
    differentiate) and its sparse embedding plan."""

    def __init__(self, program, fetch_names):
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
        self.sparse_plan = {} if self.ad_idx is None else \
            _sparse_embedding_plan(block.ops, self.ad_idx, persist,
                                   set(fetch_names))


# optimizer ops with a SparseRows gradient branch (ops_impl/optim_ops.py)
_SPARSE_OPTS = frozenset(['sgd', 'adagrad', 'adam'])


def _sparse_embedding_plan(ops, ad_idx, persistable, fetch_names):
    """Which embedding tables take the sparse gradient path (the JAX
    package's StepArtifact._sparse_embedding_plan, unsharded case).

    A table W qualifies when every reader of W other than its optimizer op
    is an is_sparse lookup_table, W@GRAD is read by exactly one sgd,
    adagrad or adam op and by nothing else, and W@GRAD has no writer, is
    not persistable and is not fetched (fetching it asks for the dense
    gradient). Any other table keeps the dense path.
    Returns {w_name: {'lookups': [(op_idx, ids_name, padding_idx)],
                      'gname': str}}."""
    ad = ops[ad_idx]
    gnames = dict(zip(ad.attrs['param_names'], ad.attrs['grad_names']))
    readers, writers = {}, {}
    for i, op in enumerate(ops):
        if i == ad_idx:
            continue
        for n in op.input_arg_names:
            readers.setdefault(n, []).append(i)
        for n in op.output_arg_names:
            writers.setdefault(n, []).append(i)
    plan = {}
    for w, gname in gnames.items():
        lookups = []
        opt_idx = None
        ok = gname not in fetch_names and gname not in persistable
        for i in set(readers.get(w, [])):
            op = ops[i]
            if (op.type == 'lookup_table' and op.attrs.get('is_sparse')
                    and op.inputs['W'][0].name == w):
                lookups.append((i, op.inputs['Ids'][0].name,
                                op.attrs.get('padding_idx', -1)))
            elif (op.type in _SPARSE_OPTS and opt_idx is None
                  and any(v.name == gname
                          for v in op.inputs.get('Grad', []))):
                opt_idx = i
            else:
                ok = False
        if (ok and lookups and opt_idx is not None
                and set(readers.get(gname, [])) <= {opt_idx}
                and not writers.get(gname)):
            plan[w] = {'lookups': sorted(lookups), 'gname': gname}
    return plan


def _run_ops(ops, env, ctx, detach_stop_gradient=False, taps=None):
    """Run `ops` against env; with detach_stop_gradient, every output var
    marked stop_gradient is detached (the JAX package's _run_ops in grad
    mode, fluid/step_artifact.py:591-596). taps: {op index: (tap tensor,
    output name)}: right after that op the tap is added to its output, so
    the tap's gradient is the per-row gradient there (:586-590)."""
    for i, op in enumerate(ops):
        run_op(op, env, ctx)
        if taps is not None and i in taps:
            tap, out = taps[i]
            env[out] = env[out] + tap
        if detach_stop_gradient:
            for vs in op.outputs.values():
                for v in vs:
                    t = env.get(v.name)
                    if v.stop_gradient and isinstance(t, torch.Tensor):
                        env[v.name] = t.detach()


def _train_step(ops, ad_idx, sparse_plan, env, ctx):
    """The step of a program with an autodiff op at ad_idx: the eager
    counterpart of StepArtifact's _grad_setup / _make_fwd / _apply_grads
    (fluid/step_artifact.py:412-501)."""
    ad = ops[ad_idx]
    gnames = dict(zip(ad.attrs['param_names'], ad.attrs['grad_names']))
    # the planned tables whose ids are known before the forward runs (fed
    # or persistable), which the taps' shapes need; the others stay dense
    sparse = {w: p for w, p in sparse_plan.items()
              if w in env and all(ids in env for _, ids, _ in p['lookups'])}
    taps = {}
    for w, p in sparse.items():
        d = env[w].shape[-1]
        for op_idx, ids_name, _ in p['lookups']:
            shape = tuple(env[ids_name].shape)
            if shape and shape[-1] == 1:
                shape = shape[:-1]
            taps[op_idx] = (torch.zeros(shape + (d,), dtype=env[w].dtype,
                                        device=env[w].device,
                                        requires_grad=True),
                            ops[op_idx].outputs['Out'][0].name)
    pnames = [n for n in ad.attrs['param_names']
              if n in env and n not in sparse]
    leaves = [env[n].detach().requires_grad_() for n in pnames]
    env.update(zip(pnames, leaves))
    tap_order = sorted(taps)
    # record_function ranges name the phases in a torch.profiler trace
    # (tools/torch_train_profile.py); without a profiler they cost ~1 us
    with torch.enable_grad():
        with record_function('executor.forward'):
            _run_ops(ops[:ad_idx], env, ctx, detach_stop_gradient=True,
                     taps=taps)
            loss = env[ad.attrs['loss_name']].to(torch.float32).sum()
        grads = torch.autograd.grad(
            loss, leaves + [taps[i][0] for i in tap_order],
            allow_unused=True)
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
    tap_grads = dict(zip(tap_order, grads[len(leaves):]))
    for w, p in sparse.items():
        d = env[w].shape[-1]
        ids_parts, row_parts = [], []
        for op_idx, ids_name, pad in p['lookups']:
            ids = env[ids_name].reshape(-1).long()
            g = tap_grads[op_idx]
            rows = torch.zeros((ids.shape[0], d), dtype=env[w].dtype,
                               device=ids.device) if g is None \
                else g.reshape(-1, d)
            if pad is not None and pad >= 0:
                # the dense gradient's padding_idx row is zero (the lookup
                # reads that row as zeros); mirror it on the rows
                rows = rows.masked_fill((ids == pad)[:, None], 0.0)
            ids_parts.append(ids)
            row_parts.append(rows)
        rows = torch.cat(row_parts)
        if scale != 1.0:
            rows = rows * scale
        env[p['gname']] = SparseRows(torch.cat(ids_parts),
                                     rows.to(env[w].dtype), env[w].shape)
    with torch.no_grad(), record_function('executor.update'):
        _run_ops(ops[ad_idx + 1:], env, ctx)


class StepHandle(object):
    """Pinned runner of ONE feedless step program: the continuous-batching
    decode engine calls the same step thousands of times (JAX
    executor.py:464, reduced to what the engine uses).

    The persistables the program writes live INSIDE the handle between
    calls, read-only ones (the weights) are fixed at acquire time, and the
    scope is kept in sync after every step, so nothing walks the scope per
    call. `step()` runs the ops under torch.no_grad() and returns the
    fetch list as device tensors; the caller decides when to pay the host
    sync. Callers update the tensors of `state` in place between steps
    (under no_grad), since the handle and the scope hold the same objects.
    The JAX handle's compile cache, donation, set_state and state_dict
    have no counterpart."""

    _C_STEPS = None   # registry counter, created with the first handle

    def __init__(self, exe, program, scope, fetch_names, plan):
        self._exe = exe
        self._block = program.global_block()
        self._scope = scope
        self._fetch = fetch_names
        writes = set(plan.writes)
        self._written = {n: scope._chain_get(n) for n in plan.persistables
                         if n in writes}
        self._fixed = {n: scope._chain_get(n) for n in plan.persistables
                       if n not in writes}
        self.steps = 0
        if StepHandle._C_STEPS is None:
            StepHandle._C_STEPS = obs.counter('executor.handle.steps')

    @property
    def state(self):
        """name -> tensor view of the step's persistable state (written
        and read-only)."""
        view = dict(self._fixed)
        view.update(self._written)
        return view

    def step(self):
        """One execution; returns the fetch list as device tensors."""
        env = dict(self._fixed)
        env.update(self._written)
        exe = self._exe
        with exe._lock, torch.no_grad():
            run_block(self._block, env, Ctx(exe.device, exe._generator))
        for n in self._written:
            self._written[n] = env[n]
            self._scope._chain_set(n, env[n])
        self.steps += 1
        StepHandle._C_STEPS.inc()
        return [env[n] for n in self._fetch]


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

    def _plan(self, program, fetch_names):
        key = (program._uid, program._version, fetch_names)
        plan = self._plans.get(key)
        if plan is None:
            plan = self._plans[key] = _RunPlan(program, fetch_names)
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
        fetch_names = tuple(_as_fetch_name(f) for f in fetch_list)
        with obs.span('executor.step'), self._lock:
            plan = self._plan(program, fetch_names)
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
                _train_step(block.ops, plan.ad_idx, plan.sparse_plan, env,
                            ctx)
            else:
                mode = torch.no_grad() if plan.writes \
                    else torch.inference_mode()
                with mode:
                    run_block(block, env, ctx)
            for name in plan.writes:
                if name in env:
                    scope._chain_set(name, env[name])
            fetches = [env[n] for n in fetch_names]
            if not return_numpy:
                return fetches
            with obs.span('executor.fetch'):
                return [self._to_numpy(t) for t in fetches]

    def acquire_step(self, program=None, feed=None, fetch_list=None,
                     scope=None):
        """Resolve a feedless state-update program ONCE and return a pinned
        StepHandle whose repeated `.step()` calls skip run()'s per-call
        work. Every persistable it reads or writes must already have a
        scope value (run the startup program first)."""
        if program is None:
            program = default_main_program()
        if scope is None:
            scope = global_scope()
        if feed:
            raise ValueError('acquire_step: the handle runs feedless state-'
                             'update programs; got feed %r' % sorted(feed))
        fetch_names = tuple(_as_fetch_name(f) for f in fetch_list or [])
        plan = self._plan(program, fetch_names)
        if plan.ad_idx is not None:
            raise ValueError('acquire_step: a training program (autodiff op) '
                             'runs through run()')
        gap = [n for n in plan.persistables if scope._chain_get(n) is None]
        if gap:
            raise ValueError(
                'acquire_step: persistable(s) %r have no scope value yet; a '
                'handle needs its whole state; run the startup program '
                'first' % gap)
        return StepHandle(self, program, scope, fetch_names, plan)

    @staticmethod
    def _to_numpy(t):
        a = t.detach().cpu().numpy()
        # a CPU tensor's numpy view would alias scope or cached state
        return a.copy() if t.device.type == 'cpu' else a

    def close(self):
        pass
