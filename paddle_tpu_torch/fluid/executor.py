"""Executor: thin entry points over the compiled step
(fluid/step_artifact.py).

Parity: reference python/paddle/fluid/executor.py:256 and the JAX
package's fluid/executor.py (anomaly_guard :146, FetchHandle :373,
StepHandle :464, run :1456, acquire_step :1568, run_bundle :1647,
_observe_health :1854, state_dict :1955, cache_stats :2046). Each entry
point resolves one StepArtifact per (program uid and version, feed
signature, fetch names, guard, amp) through `_prepare` and runs it:

  * on a CUDA place, a signature's first call is its eager warm-up, the
    second captures it into a CUDA graph and every later call replays it
    (StepArtifact.run_captured); the scope's persistables are the graph's
    static state and are updated in place;
  * on the CPU the artifact runs its eager body, and the written
    persistables are rebound in the scope, as the JAX package's functional
    step rebinds them;
  * while fluid.debugger.check_nan_inf() is active, every place takes the
    eager walk (StepArtifact.debug_step), which checks each op's outputs.

Replays, fetch copies and capture serialize on the executor's lock, and
every fetch leaves the executor's graph pool before the lock is released:
numpy fetches through pinned host buffers, device fetches as clones.

Random ops draw from ONE torch.Generator per Executor, on its device,
seeded at every run from Program.random_seed and the run count (the JAX
Executor derives its per-run PRNG key the same way), so a seeded program
gives the same numbers run for run, captured or eager, bundled or not.

Before a cache key's artifact is built, the pass pipeline
(fluid/passes: PADDLE_TPU_OPT, a quant-marked program) may rewrite the
program; the artifact runs the optimized clone (`_build_artifact`).

A program on a dp mesh (Program.set_mesh, ParallelExecutor,
DistributeTranspiler; fluid/mesh_step.py) runs on every rank of the
process group: the feed is the global batch and each rank takes its rows
(a batch the data axis does not divide raises "not divisible"), the scope
holds each ZeRO-split persistable as the rank's block, and every rank
returns the global fetches. Random ops draw per rank: the seed of a run is
offset by the rank.

The JAX Executor's verify gate, AOT warm signatures, persistent compile
cache and remat detection have no counterpart yet (ROADMAP.md Queue A).
"""
import collections
import contextlib
import threading
import warnings
import weakref

import numpy as np
import torch

from .. import obs
from . import amp as amp_mod
from . import core
from . import debugger
from . import mesh_step
from . import passes as passes_mod
from .data_feeder import seq_pad
from .framework import Variable, default_main_program
from .lod_tensor import LoDTensor
from .lowering import SeqValue, leaves_of, map_value
from ..parallel import LocalRows
from .ops_impl.block_ops import check_loops
from .passes import quant_pass
from .step_artifact import (StepArtifact, _feed_signature, _pack_health,
                            _write_back, health_to_numpy)

__all__ = ['Executor', 'Scope', 'StepHandle', 'FetchHandle',
           'global_scope', 'scope_guard', '_switch_scope', 'anomaly_guard']


class _VarHolder(object):
    """The pybind Variable handle (find_var().get_tensor()), the JAX
    :175."""

    def __init__(self, scope, name):
        self._scope = scope
        self._name = name

    def get_tensor(self):
        return _TensorHandle(self._scope, self._name)

    def set(self, value, place=None):
        self._scope._set_tensor(self._name, value, place)


class _TensorHandle(object):
    """The pybind Tensor surface on a scope var (the JAX :189): reads like
    an ndarray (__array__), writes back with set(value, place), so the
    reference idiom `scope.find_var(n).get_tensor().set(arr, place)` loads
    a pretrained parameter (book test_label_semantic_roles.py:180)."""

    def __init__(self, scope, name):
        self._scope = scope
        self._name = name

    def _raw(self):
        v = self._scope.vars[self._name]
        return v.data if isinstance(v, SeqValue) else v

    def __array__(self, dtype=None, copy=None):
        if copy is False:
            # NumPy 2's __array__ contract: a device tensor reaches numpy
            # through a copy, so a no-copy request cannot be met
            raise ValueError(
                'converting a device tensor to numpy requires a '
                'device-to-host copy; copy=False cannot be satisfied')
        a = numpy_of(self._raw().detach().cpu()).copy()
        if dtype is not None and a.dtype != np.dtype(dtype):
            a = a.astype(dtype)
        return a

    def set(self, value, place=None):
        self._scope._set_tensor(self._name, value, place)

    def shape(self):
        # metadata only: no copy to the host
        return list(self._raw().shape)

    def __repr__(self):
        return '_TensorHandle(%r, shape=%r)' % (self._name, self.shape())


class Scope(object):
    """name -> tensor store, optionally chained to a parent scope
    (reference paddle/fluid/framework/scope.h: kid scopes fall back to the
    parent on lookup; writes stay local)."""

    def __init__(self, parent=None):
        self.vars = collections.OrderedDict()
        self.parent = parent

    def find_var(self, name):
        """A handle on `name` in this scope or the nearest parent that
        holds it, or None."""
        if name in self.vars:
            return _VarHolder(self, name)
        if self.parent is not None:
            return self.parent.find_var(name)
        return None

    def var(self, name):
        """A handle on `name`, created empty in this scope if absent."""
        self.vars.setdefault(name, None)
        return _VarHolder(self, name)

    def _set_tensor(self, name, value, place):
        """Bind `name` to a copy of `value` (an array or a tensor). Over a
        tensor already bound, the copy takes that tensor's device and
        dtype (a persistable keeps both: a captured step copies the new
        value into its static state before its next replay); a new name
        goes to `place`'s device, the CPU without one."""
        old = self.vars.get(name)
        t = value.detach() if isinstance(value, torch.Tensor) \
            else tensor_of_numpy(value)
        if isinstance(old, torch.Tensor):
            t = t.to(device=old.device, dtype=old.dtype)
        elif place is not None:
            t = t.to(place.torch_device())
        self.vars[name] = t.clone()

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
        parameters, read from its scope or its __params__.npz). A bf16
        array (numpy dtype name 'bfloat16', as the JAX package hands them
        out) becomes a bf16 tensor bit for bit. A captured step copies a
        rebound persistable into its static state before its next
        replay."""
        device = place.torch_device()
        for name, a in arrays.items():
            self.vars[name] = tensor_of_numpy(a).to(device)

    def to_numpy(self, names=None):
        """{name: ndarray} of the named (default: all) local variables. A
        bf16 tensor comes back widened to float32, which is exact: numpy
        has no bf16 dtype of its own."""
        names = list(self.vars) if names is None else names
        return {n: numpy_of(self.vars[n].detach().cpu()).copy()
                for n in names}


def tensor_of_numpy(a):
    """A CPU tensor holding a copy of numpy array `a`. A bf16 array (dtype
    name 'bfloat16', from ml_dtypes, which this package does not import)
    crosses through its 16-bit view, bit for bit."""
    a = np.asarray(a)
    if a.dtype.name == 'bfloat16':
        return torch.from_numpy(
            np.array(a.view(np.int16), copy=True)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def numpy_of(t):
    """A CPU tensor as a numpy array (a view where numpy has the dtype): a
    bf16 tensor widened to float32, which is exact."""
    if t.dtype == torch.bfloat16:
        return t.to(torch.float32).numpy()
    return t.numpy()


_global_scope = Scope()


def _unstack(template, leaves, j):
    """Step j of a bundle's stacked feed: a tensor, or a SeqValue of
    template's structure."""
    if isinstance(template, SeqValue):
        return template.with_leaves(t[j] for t in leaves)
    return leaves[0][j]


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


def anomaly_guard(program=None, enable=True, max_consecutive_skips=None):
    """Arm the in-graph anomaly guard on a training program (the JAX
    :146): each step computes a health vector on the card (finiteness of
    the loss and of every gradient, and the global gradient norm) and,
    when the step is unhealthy, skips it: every written persistable
    (parameters, optimizer state, running stats) keeps its pre-step value
    through a torch.where select inside the captured graph.

    After each guarded run `exe.last_step_health` holds the health vector
    (numpy) and `exe.skipped_steps` counts skips. With
    max_consecutive_skips=N the N-th consecutive unhealthy step raises
    FloatingPointError on the host. The eager per-op attribution mode is
    fluid.debugger.check_nan_inf()."""
    if program is None:
        program = default_main_program()
    program._anomaly_guard = bool(enable)
    program._anomaly_guard_max_skips = max_consecutive_skips
    program._bump_version()
    return program


# Process-wide executor telemetry; per-instance numbers are in
# Executor.cache_stats.
_C_HITS = obs.counter('executor.cache.hits')
_C_MISSES = obs.counter('executor.cache.misses')
_C_EVICTIONS = obs.counter('executor.cache.evictions')
_C_BUNDLED_STEPS = obs.counter('executor.bundle.steps')
_C_SKIPPED = obs.counter('anomaly.skipped_steps')
# the pass pipeline's fallbacks to the unoptimized program (passes.error)
_C_PASS_ERRORS = obs.counter('passes.errors')
_G_GRAD_NORM = obs.gauge('anomaly.grad_norm')
# run(sync='async') handles not yet read (the host_stall histogram comes
# from the obs.span in FetchHandle.block)
_G_INFLIGHT = obs.gauge('executor.inflight')

# RLock: FetchHandle.__del__ may run from a GC pass triggered inside an
# _inflight_delta call on the same thread
_inflight_lock = threading.RLock()
_inflight_n = 0


def _inflight_delta(d):
    global _inflight_n
    with _inflight_lock:
        _inflight_n += d
        _G_INFLIGHT.set(_inflight_n)


class FetchHandle(object):
    """A lazy fetch of `run(sync='async')` (the JAX :373): the host waits
    for the value at its FIRST READ (np.asarray, float(), .block()), not
    inside run(), so the host can go on to the next step while the card
    works on this one.

      * the first read blocks until the copy out of the step has landed
        (a CUDA event recorded after it), records the wait in the
        executor.host_stall.seconds histogram and caches the result;
      * `.ready` asks without blocking;
      * a failure of the copy or of the conversion raises at the first
        read and again at every later read;
      * the executor.inflight gauge counts handles made minus handles read
        (or collected unread)."""

    __slots__ = ('_value', '_materialize', '_event', '_result', '_synced')

    def __init__(self, value, materialize=None, event=None):
        self._value = value
        self._materialize = materialize if materialize is not None \
            else (lambda v=value: np.asarray(v))
        self._event = event
        self._result = None
        self._synced = False
        _inflight_delta(1)

    @property
    def ready(self):
        """Non-blocking: has the card finished producing this value?"""
        if self._synced or self._event is None:
            return True
        return bool(self._event.query())

    def block(self):
        """The value on the host (cached); re-raises a deferred error at
        every read."""
        if not self._synced:
            was_ready = self.ready
            try:
                with obs.span('executor.host_stall', ready=was_ready):
                    if self._event is not None:
                        self._event.synchronize()
                    self._result = (True, self._materialize())
            except Exception as e:  # noqa: BLE001 - deferred to the reader
                self._result = (False, e)
            finally:
                self._synced = True
                self._value = self._materialize = self._event = None
                _inflight_delta(-1)
        ok, payload = self._result
        if ok:
            return payload
        raise payload

    def __array__(self, dtype=None, copy=None):
        a = np.asarray(self.block())
        if dtype is not None and a.dtype != np.dtype(dtype):
            a = a.astype(dtype)
        elif copy:
            a = a.copy()
        return a

    def __float__(self):
        a = np.asarray(self.block())
        if a.size != 1:
            raise TypeError(
                'float() on a fetch handle of shape %r: only one-element '
                'fetches convert to a scalar' % (a.shape,))
        return float(a.reshape(-1)[0])

    def __del__(self):
        # a handle never read gives its inflight slot back
        if not getattr(self, '_synced', True):
            self._synced = True
            try:
                _inflight_delta(-1)
            except Exception:  # noqa: BLE001 - interpreter shutdown
                pass

    def __repr__(self):
        state = 'synced' if self._synced else (
            'ready' if self.ready else 'pending')
        return 'FetchHandle(%s)' % state


class StepHandle(object):
    """A pinned runner of ONE step artifact (the JAX :464): the decode
    engine calls the same step thousands of times, and run()'s per-call
    work (feed coercion, cache key, scope walk) would dominate it.
    `Executor.acquire_step` resolves the artifact once; `step(feed, seed)`
    runs it, on the card as a replay of its captured graph, and returns
    the fetch list as device tensors (on the card clones taken out of the
    graph's pool, so the next replay leaves them as they are).

    The written persistables are the handle's state between calls and the
    scope holds the same tensors. On the card they are the graph's static
    tensors: callers may update `state` tensors in place between steps
    (under no_grad), or replace one with `set_state`, which copies into
    the static tensor. On the CPU a step rebinds them, as the JAX step
    does. The handle raises when another entry point rebound one of them
    in the scope since its last step: it must be the only runner of its
    (program, scope). Random ops see seed 0 unless `seed` is passed."""

    __slots__ = ('_exe', '_compiled', '_scope', '_program', '_donated',
                 '_readonly', 'steps', 'key_id')

    _C_STEPS = None   # registry counter, created with the first handle

    def __init__(self, exe, compiled, scope, program, key_id):
        self._exe = exe
        self._compiled = compiled
        self._scope = scope
        self._program = program
        self._donated, self._readonly = compiled.plan.split(
            compiled._scope_state(scope))
        self.steps = 0
        self.key_id = key_id
        if StepHandle._C_STEPS is None:
            StepHandle._C_STEPS = obs.counter('executor.handle.steps')

    @property
    def state(self):
        """name -> tensor of the step's persistable state (written and
        read-only)."""
        view = dict(self._readonly)
        view.update(self._donated)
        return view

    def state_dict(self):
        """{name: tensor} of this step's persistable state, read through
        the scope the handle keeps in sync."""
        return self._compiled.state_dict(self._scope)

    def set_state(self, name, value):
        """Replace one persistable between steps: on the card the value is
        copied into the step's static tensor, on the CPU it is rebound."""
        if name in self._donated:
            held = self._donated
        elif name in self._readonly:
            held = self._readonly
        else:
            raise KeyError('no persistable %r in this step (have %r)'
                           % (name, sorted(self._donated)
                              + sorted(self._readonly)))
        t = held[name]
        value = torch.as_tensor(value)
        if (self._exe.device.type == 'cuda' and value.shape == t.shape
                and value.dtype == t.dtype):
            with self._exe._lock, torch.no_grad():
                t.copy_(value)
            return
        value = value.to(self._exe.device)
        held[name] = value
        self._scope._chain_set(name, value)

    def step(self, feed=None, seed=None):
        """One execution; returns the fetch list as device tensors. `feed`
        must match the acquire-time signature (None for a feedless
        program)."""
        for n, v in self._donated.items():
            if self._scope._chain_get(n) is not v:
                raise RuntimeError(
                    'StepHandle state invalidated: persistable %r was '
                    'rewritten in the scope by another execution path '
                    '(run()/run_bundle/another handle) since the last '
                    'step: a pinned handle must be the only runner of its '
                    '(program, scope); re-acquire_step() to resume' % n)
        exe, art = self._exe, self._compiled
        feed_vals = exe._feed_values(self._program, feed or {}, art)
        sig = tuple(sorted(_feed_signature(n, v)
                           for n, v in feed_vals.items()))
        if sig != art._feed_sig:
            raise ValueError('StepHandle.step: feed signature %r, but the '
                             'handle was acquired for %r'
                             % (sig, art._feed_sig))
        with exe._lock:
            fetches, health = exe._step(art, self._scope, feed_vals,
                                        0 if seed is None else int(seed))
            if exe.device.type == 'cuda':
                fetches = [map_value(torch.clone, t) for t in fetches]
            if health is not None:
                health = health_to_numpy(health)
        for n in self._donated:
            self._donated[n] = self._scope._chain_get(n)
        if health is not None:
            exe._observe_health(self._program, health)
        self.steps += 1
        StepHandle._C_STEPS.inc()
        return fetches



def _spec_of(art):
    """The MeshSpec an artifact was built for, or None."""
    plan = getattr(art, 'mesh', None)
    return None if plan is None else plan.spec

class Executor(object):
    """Parity: reference python/paddle/fluid/executor.py:256.

    place: where every tensor of a run lives. None means CUDAPlace(0), and
    constructing an Executor there without a usable card raises: pass
    CPUPlace() to run on the CPU. Its entry points are thread-safe:
    concurrent calls serialize on the executor."""

    def __init__(self, place=None):
        self.place = core.CUDAPlace(0) if place is None else place
        self.device = self.place.torch_device()
        self._generator = torch.Generator(device=self.device)
        self._run_counter = 0
        self._cache = {}
        self._lock = threading.RLock()
        # the anomaly guard's host side (see anomaly_guard())
        self.last_step_health = None
        self.skipped_steps = 0
        self._consecutive_skips = 0
        self._cache_hits = 0
        self._cache_misses = 0
        self._cache_evictions = 0
        self._captures = 0
        self._replays = 0
        self._last_cache_lookup = None   # {'outcome', 'key', 'entries'}
        self._stream = None              # warm-up and capture stream
        self._pool = None                # the captured graphs' memory pool
        self._graphs = weakref.WeakSet()  # records of its live graphs

    def _side_stream(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    @property
    def _graph_pool(self):
        """One memory pool for every graph this executor captures: safe,
        as replays serialize on the lock and fetches leave the pool before
        it is released. Once no graph of the pool is alive (its scopes
        gone, the executor closed, a capture failed), the caching allocator
        releases it, so the next capture opens a new one."""
        if self._pool is None or not self._graphs:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    @staticmethod
    def _seed(program, n, art):
        s = ((program.random_seed or 0) * 2654435761 + n) % (1 << 63)
        spec = _spec_of(art)
        if spec is not None and spec.rank:
            # each rank draws its own masks for its rows
            s = (s + spec.rank * 0x9E3779B97F4A7C15) % (1 << 63)
        return s

    def _feed_value(self, val, var):
        """One feed as a tensor of the var's dtype, or a SeqValue (the JAX
        :693-714, :1029-1033): a LoDTensor becomes its padded SeqValue,
        its time axis the DataFeeder's power-of-two bucket of its longest
        sequence (the JAX package pads to the longest; every rule masks
        past the lengths, so the fetches agree, and requests whose longest
        sequences share a bucket share one artifact and, on the card, one
        captured graph) or 1 for nested LoD of length-1 sequences
        (data_feeder.seq_pad), a SeqValue keeps its lengths, and a dense feed of
        a lod var becomes a SeqValue whose rows are all full length. Its
        data takes the var's dtype; lengths are int64."""
        if isinstance(val, LoDTensor):
            lens = val.recursive_sequence_lengths()
            val = val.to_seq_value(pad_to=seq_pad(lens) if lens else None)
        if isinstance(val, SeqValue):
            return SeqValue(
                self._feed_tensor(val.data, var),
                self._feed_tensor(val.lengths, None).long(),
                tuple(self._feed_tensor(o, None).long()
                      for o in val.outer_lengths or ()),
                beam_cap=val.beam_cap)
        t = self._feed_tensor(val, var)
        if var is not None and var.lod_level and var.lod_level > 0:
            return SeqValue(t, torch.full((t.shape[0],), t.shape[1],
                                          dtype=torch.int64,
                                          device=t.device))
        return t

    def _feed_tensor(self, val, var):
        """One feed as a tensor of the var's dtype, on the CPU (the
        artifact moves it to the card) or where the caller put it."""
        if isinstance(val, torch.Tensor):
            t = val
        else:
            a = np.asarray(val)
            if a.dtype.name == 'bfloat16':
                t = tensor_of_numpy(a)
            else:
                if var is not None and var.dtype != 'bfloat16' \
                        and a.dtype != np.dtype(var.dtype):
                    a = a.astype(var.dtype)
                if not (a.flags.c_contiguous and a.flags.writeable):
                    a = np.array(a, copy=True, order='C')
                t = torch.from_numpy(a)
        if var is not None:
            # a float feed of a bf16 var is rounded to bf16 here by torch
            # (to nearest, ties to even)
            t = t.to(core.torch_dtype(var.dtype))
        if t.device.type != 'cpu' and t.device != self.device:
            t = t.to(self.device)
        return t

    def _feed_values(self, program, feed, art=None):
        """The coerced feed of a run of `program` (of the artifact `art`,
        when given: its mesh)."""
        spec = mesh_step.mesh_spec(program) if art is None else _spec_of(art)
        return self._mesh_feed_values(program, feed, spec)[0]

    def _mesh_feed_values(self, program, feed, spec):
        """(the coerced feed, the names that carry this rank's rows of a
        dp-sharded batch). On the mesh `spec` each global feed is cut to
        this rank's rows after its coercion (a LoDTensor padded to the
        global batch's bucket first); a parallel.LocalRows value is the
        rank's rows already."""
        block = program.global_block()
        vals, sharded = {}, set()
        for n, v in feed.items():
            var = block.vars.get(n)
            local = isinstance(v, LocalRows)
            val = self._feed_value(v.value if local else v, var)
            if spec is not None:
                cut, rows = mesh_step.shard_feed(spec, n, val, var)
                if rows:
                    sharded.add(n)
                    val = val if local else cut
            vals[n] = val
        return vals, sharded

    def _place_feed(self, program, feed):
        """Stage one feed dict for a later run of `program` (the JAX :1013),
        from any thread: the Trainer's prefetch worker calls it while the
        previous step runs. Each value becomes the tensor (or SeqValue) the
        step would make of it and, for a card, is copied into pinned host
        memory; the step then copies it to the card without a host copy of
        its own. Nothing is allocated or copied on the card here: that copy
        stays in the step, under the executor's lock on the stream the step
        runs on, so a staging thread cannot race a capture or a replay's
        feed buffers. Every entry point takes the result as a feed."""
        vals, sharded = self._mesh_feed_values(
            program, feed, mesh_step.mesh_spec(program))
        if self.device.type == 'cuda':
            vals = {n: map_value(lambda t: t.pin_memory()
                                 if t.device.type == 'cpu' else t, v)
                    for n, v in vals.items()}
        # a mesh feed staged here is this rank's rows already
        return {n: LocalRows(v) if n in sharded else v
                for n, v in vals.items()}

    def _prepare(self, program, feed, fetch_list, scope,
                 use_program_cache=True):
        """Coerce the feed, resolve the (program, feed signature, fetch,
        guard, amp, quant mark, pass level) cache key and build or fetch
        its StepArtifact. Returns (artifact, feed tensors)."""
        spec = mesh_step.mesh_spec(program)
        self._check_mesh(program, spec)
        if spec is not None:
            mesh_step.place_scope(spec, program, scope)
        feed_vals, sharded = self._mesh_feed_values(program, feed, spec)
        fetch_names = tuple(_as_fetch_name(f) for f in fetch_list)
        feed_sig = tuple(sorted(_feed_signature(n, v)
                                for n, v in feed_vals.items()))
        guard = bool(getattr(program, '_anomaly_guard', False))
        # AMP changes what the rules compute: one program run with and
        # without it builds (and on the card captures) two steps
        amp = amp_mod.is_amp(program)
        # the pass level and the quant mark change the program the step
        # runs: marking a program after it ran builds a new step
        opt = passes_mod.opt_mode()
        quant = quant_pass.is_quant(program)
        key = (program._uid, program._version, feed_sig, fetch_names, guard,
               amp, quant, opt, None if spec is None else spec.key(),
               tuple(sorted(sharded)))
        key_id = '%08x' % (hash(key) & 0xFFFFFFFF)
        art = self._cache.get(key) if use_program_cache else None
        if art is None:
            self._cache_misses += 1
            _C_MISSES.inc()
            persist_in = sorted(
                v.name for v in program.list_vars()
                if v.persistable and v.name not in feed_vals
                and scope._chain_get(v.name) is not None)
            art = self._build_artifact(program, feed_vals, fetch_names,
                                       persist_in, guard, amp, quant, opt,
                                       key_id, spec, sharded)
            art._feed_sig = feed_sig
            art._key_id = key_id
            art._source_program = program
            obs.event('executor.artifact', key=key_id,
                      feeds=len(feed_vals), fetches=len(fetch_names),
                      persistables=len(persist_in),
                      writes=len(art.donate_names))
            if use_program_cache:
                self._cache[key] = art
            outcome = 'miss'
        else:
            self._cache_hits += 1
            _C_HITS.inc()
            outcome = 'hit'
        self._last_cache_lookup = {'outcome': outcome, 'key': key_id,
                                   'entries': len(self._cache)}
        return art, feed_vals

    def _build_artifact(self, program, feed_vals, fetch_names, persist_in,
                        guard, amp, quant, opt, key_id, spec=None,
                        sharded=()):
        """The StepArtifact of one cache key, built from the program the
        pass pipeline makes of `program` (the JAX :1115-1200): at
        PADDLE_TPU_OPT off the program itself, unless it is quant-marked
        (the mark has no other effect, so it is honoured at every level).
        Folding evaluates on this executor's device. A pass failure, or an
        optimized program the artifact cannot be built from, warns, emits
        `passes.error` and builds from the unoptimized program; it hides
        no device or kernel failure, which happen later, in the step."""
        run_program = program
        if opt != 'off' or quant:
            try:
                run_program, _ = passes_mod.optimize(
                    program, feeds=set(feed_vals), fetches=fetch_names,
                    level=opt if opt != 'off' else 'default',
                    where='executor', device=self.device)
            except Exception as e:  # noqa: BLE001 - fall back, loudly
                self._pass_failed(opt, key_id, 'optimize', e)
                run_program = program
        try:
            return StepArtifact(run_program, list(feed_vals), fetch_names,
                                persist_in, guard=guard, amp=amp, mesh=spec,
                                sharded_feeds=sharded)
        except NotImplementedError:
            raise
        except Exception as e:  # noqa: BLE001 - fall back, loudly
            if run_program is program:
                raise
            self._pass_failed(opt, key_id, 'artifact', e)
            return StepArtifact(program, list(feed_vals), fetch_names,
                                persist_in, guard=guard, amp=amp, mesh=spec,
                                sharded_feeds=sharded)

    def _check_mesh(self, program, spec):
        """A mesh program runs where its process group does: NCCL on this
        rank's card, gloo on the CPU. A DistributeTranspiler program with
        sync_mode=False warns once that it runs synchronously (the JAX
        :781-798)."""
        group = None if spec is None else spec.group
        if group is not None:
            backend = torch.distributed.get_backend(group)
            want = 'cuda' if backend == 'nccl' else 'cpu'
            if self.device.type != want or (
                    want == 'cuda'
                    and self.device.index != torch.cuda.current_device()):
                raise ValueError(
                    'a %s process group runs its mesh on %s; this executor '
                    'is on %s' % (backend, 'cuda:%d' % torch.cuda.current_device()
                                  if want == 'cuda' else 'the CPU',
                                  self.device))
        dist = getattr(program, '_dist_config', None)
        if dist and not dist.get('sync_mode', True) and not getattr(
                program, '_async_warned', False):
            warnings.warn(
                "DistributeTranspiler sync_mode=False: the program path "
                "runs SYNCHRONOUS data-parallel (the gradients are averaged "
                "every step). For async-style training use "
                "paddle_tpu_torch.parallel.LocalSGD (periodic parameter "
                "averaging).", UserWarning, stacklevel=4)
            program._async_warned = True

    @staticmethod
    def _pass_failed(opt, key_id, stage, e):
        warnings.warn(
            '%s=%s: program optimization failed at %s (%s: %s); running '
            'the unoptimized program' % (passes_mod.ENV_OPT, opt, stage,
                                         type(e).__name__, e),
            RuntimeWarning)
        _C_PASS_ERRORS.inc()
        obs.event('passes.error', key=key_id, stage=stage,
                  error='%s: %s' % (type(e).__name__, e))

    def _step(self, art, scope, feed_vals, seed):
        """One step of `art` (the lock held): a warm-up, capture or replay
        on the card, the eager body on the CPU, the eager walk with its
        checks under fluid.debugger.check_nan_inf(). Returns (fetches,
        health); on a replay the fetches are the graph's outputs."""
        check = debugger.nan_inf_check_active()
        if self.device.type == 'cuda' and not check:
            out = art.run_captured(self, scope, feed_vals, seed)
            check_loops(art.last_loops)
            return out
        persist = art._scope_state(scope)
        feed = {n: map_value(lambda t: t.to(self.device), v)
                for n, v in feed_vals.items()}
        if check:
            fetches, new, health = art.debug_step(
                persist, feed, seed, check_nan_inf=True,
                generator=self._generator)
        else:
            fetches, new, health = art(persist, feed, seed, self._generator)
            check_loops(art.last_loops)
        _write_back(scope, new, in_place=self.device.type == 'cuda')
        return fetches, health

    def run(self, program=None, feed=None, fetch_list=None,
            feed_var_name='feed', fetch_var_name='fetch', scope=None,
            return_numpy=True, use_program_cache=True, sync='auto'):
        """Run `program` once: feeds in, fetches out. Persistables the
        program writes land in `scope`.

        return_numpy: numpy arrays (through pinned host buffers on the
        card), or with False device tensors (clones, which a later step
        leaves as they are). use_program_cache=False builds a fresh
        artifact for this call (on the card: an eager warm-up, never a
        capture). sync: 'auto' and 'block' return the fetches ready;
        'async' returns FetchHandles right after the step is launched, and
        the host waits at their first read. An armed anomaly guard reads
        its health vector on the host every step, so it waits there (a
        host stall with cause anomaly_guard)."""
        if sync not in ('auto', 'block', 'async'):
            raise ValueError(
                "sync must be 'auto', 'block' or 'async', got %r" % (sync,))
        if program is None:
            program = default_main_program()
        if scope is None:
            scope = global_scope()
        with obs.span('executor.step') as sp, self._lock:
            art, feed_vals = self._prepare(program, feed or {},
                                           fetch_list or [], scope,
                                           use_program_cache)
            self._run_counter += 1
            look = self._last_cache_lookup
            sp.fields.update(run=self._run_counter, cache=look['outcome'],
                             key=look['key'])
            fetches, health = self._step(
                art, scope, feed_vals, self._seed(program,
                                                  self._run_counter, art))
            if health is not None:
                with (obs.span('executor.host_stall', cause='anomaly_guard')
                      if sync == 'async' else contextlib.nullcontext()):
                    self._observe_health(program, health_to_numpy(health))
            with obs.span('executor.fetch', sync=sync):
                return self._convert_fetches(program, fetches, return_numpy,
                                             sync == 'async')

    def _convert_fetches(self, program, fetches, return_numpy, lazy):
        """The fetches out of the step: numpy arrays, device tensors or
        lazy FetchHandles over either. On the card every copy is enqueued
        here, before the lock is released: numpy through pinned host
        buffers, device tensors as clones out of the graph pool.

        A program with `_fetch_f32` (Float16Transpiler's contract, the JAX
        _convert_fetch) fetches its bf16 values as fp32, cast on their
        device. numpy has no bf16 dtype, so any other bf16 numpy fetch is
        widened to fp32 on the host (numpy_of): exact either way.

        A SeqValue fetch (the JAX :1626-1640) comes back as the flat valid
        rows in numpy, or as a LoDTensor with return_numpy=False; on the
        card its tensors leave the graph's pool whole (cloned) before the
        host reads them."""
        if getattr(program, '_fetch_f32', False):
            fetches = [map_value(
                lambda t: t.to(torch.float32) if t.dtype == torch.bfloat16
                else t, v) for v in fetches]
        if any(isinstance(v, SeqValue) for v in fetches):
            return self._convert_seq_fetches(fetches, return_numpy, lazy)
        if self.device.type != 'cuda':
            if not return_numpy:
                return [FetchHandle(t, lambda t=t: t) for t in fetches] \
                    if lazy else list(fetches)
            if lazy:
                return [FetchHandle(t, lambda t=t: self._to_numpy(t))
                        for t in fetches]
            return [self._to_numpy(t) for t in fetches]
        if return_numpy:
            outs = []
            for t in fetches:
                host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                host.copy_(t, non_blocking=True)
                outs.append(host)
        else:
            outs = [t.clone() for t in fetches]
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        if lazy:
            return [FetchHandle(o, (lambda o=o: numpy_of(o)) if return_numpy
                                else (lambda o=o: o), event=ev)
                    for o in outs]
        if return_numpy:
            ev.synchronize()
            return [numpy_of(o) for o in outs]
        return outs

    def _convert_seq_fetches(self, fetches, return_numpy, lazy):
        """_convert_fetches for a fetch list holding a SeqValue: every
        value is cloned out of the step (on the card, out of the graph's
        pool) and read on the host at materialization."""
        outs = [map_value(torch.clone, v) if self.device.type == 'cuda'
                else v for v in fetches]
        ev = None
        if self.device.type == 'cuda':
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))

        def mat(v):
            if isinstance(v, SeqValue):
                lt = LoDTensor.from_seq_value(v)
                return np.asarray(lt.data) if return_numpy else lt
            return self._to_numpy(v) if return_numpy else v

        if lazy:
            return [FetchHandle(v, lambda v=v: mat(v), event=ev)
                    for v in outs]
        if ev is not None:
            ev.synchronize()
        return [mat(v) for v in outs]

    def acquire_step(self, program=None, feed=None, fetch_list=None,
                     scope=None):
        """Resolve (program, feed signature, fetch) ONCE and return a pinned
        StepHandle (the JAX :1568). `feed` is an example fixing the
        signature (None or {} for a feedless state-update program). The
        artifact is the one run() would use, from the same cache. Every
        persistable the program writes must already have a scope value
        (run the startup program first)."""
        if program is None:
            program = default_main_program()
        if scope is None:
            scope = global_scope()
        with self._lock:
            art, _ = self._prepare(program, feed or {}, fetch_list or [],
                                   scope)
            gap = art.uninitialized(scope)
            if gap:
                raise ValueError(
                    'acquire_step: program writes persistable(s) %r that '
                    'have no scope value yet: a handle needs its whole '
                    'state; run the startup program first' % gap)
            if self.device.type == 'cuda':
                art.pin_state(scope, self.device)
            return StepHandle(self, art, scope, program,
                              self._last_cache_lookup['key'])

    def step_artifact(self, program=None, feed=None, fetch_list=None,
                      scope=None):
        """The cached StepArtifact of (program, feed signature, fetch),
        resolved as run() resolves it: the seam for readers of artifact
        metadata (touched_rows, sparse_plan, signatures)."""
        if program is None:
            program = default_main_program()
        if scope is None:
            scope = global_scope()
        with self._lock:
            return self._prepare(program, feed or {}, fetch_list or [],
                                 scope)[0]

    def run_bundle(self, program=None, feeds=None, fetch_list=None,
                   steps=None, scope=None, return_numpy=True,
                   use_program_cache=True, sync='auto'):
        """Run K steps with one host round trip (the JAX :1647).

        feeds: K per-step feed dicts of one signature; steps, when given,
        must equal len(feeds). On the card the K feeds cross to the card in
        one copy per name into a [K, ...] buffer, and the step's captured
        graph is replayed K times back to back, each replay reading its
        slice; the host waits once, for the stacked fetches.

        The same as K run() calls: inner step j draws the seed run j would
        (the same dropout masks); the anomaly guard rolls back each
        unhealthy inner step in the graph, and the host observes the K
        health vectors after the bundle (so max_consecutive_skips raises
        after it, with the state of its end); persistables are in the
        scope at the end. Returns one entry per fetch, stacked on a leading
        K axis, or for a sequence fetch a list of K values as run() gives
        them (flat valid rows, or LoDTensors with return_numpy=False); with
        sync='async', FetchHandles over the same."""
        if sync not in ('auto', 'block', 'async'):
            raise ValueError(
                "sync must be 'auto', 'block' or 'async', got %r" % (sync,))
        if program is None:
            program = default_main_program()
        if scope is None:
            scope = global_scope()
        feeds = list(feeds or [])
        if not feeds:
            raise ValueError('run_bundle needs a non-empty list of '
                             'per-step feed dicts')
        K = len(feeds)
        if steps is not None and int(steps) != K:
            raise ValueError('steps=%d but %d feed dicts were given'
                             % (steps, K))
        with obs.span('executor.bundle', steps=K) as bsp, self._lock:
            art, feed0 = self._prepare(program, feeds[0], fetch_list or [],
                                       scope, use_program_cache)
            look = self._last_cache_lookup
            bsp.fields.update(cache=look['outcome'], key=look['key'])
            extras = art.uninitialized(scope)
            if extras:
                raise ValueError(
                    'run_bundle: persistable output(s) %r have no value in '
                    'the scope yet; run the startup program (or one '
                    'unbundled step) first so every persistable is '
                    'initialized' % (extras,))
            per_step = [feed0]
            for j, f in enumerate(feeds[1:], start=1):
                if set(f) != set(feed0):
                    raise ValueError(
                        'run_bundle feed %d has names %r, expected %r: a '
                        'bundle runs one step signature'
                        % (j, sorted(f), sorted(feed0)))
                fv = self._feed_values(program, f, art)
                for n, t in fv.items():
                    got = _feed_signature(n, t)
                    want = _feed_signature(n, feed0[n])
                    if got != want:
                        raise ValueError(
                            'run_bundle feed %d input %r has shape and '
                            'dtype %r, expected %r (step 0): a bundle runs '
                            'one step signature' % (j, n, got[1:], want[1:]))
                per_step.append(fv)
            run_base = self._run_counter
            self._run_counter += K
            _C_BUNDLED_STEPS.inc(K)
            art.bundle_signature(K)
            seeds = [self._seed(program, run_base + j + 1, art)
                     for j in range(K)]
            if self.device.type == 'cuda':
                # one copy per name: the K feeds stacked in pinned memory
                stacked = {}
                for n in feed0:
                    leaves = []
                    for i, t0 in enumerate(leaves_of(feed0[n])):
                        t = torch.stack([leaves_of(f[n])[i].to(t0.device)
                                         for f in per_step])
                        if t.device.type == 'cpu':
                            t = t.pin_memory()
                        leaves.append(t.to(self.device, non_blocking=True))
                    stacked[n] = leaves
                per_step = [{n: _unstack(feed0[n], ls, j)
                             for n, ls in stacked.items()}
                            for j in range(K)]
            outs, seqs, hbuf = None, None, None
            for j in range(K):
                fetches, health = self._step(art, scope, per_step[j],
                                             seeds[j])
                if outs is None:
                    # a sequence fetch keeps each step's own value (the
                    # JAX :1675-1677: a list of K); a dense one is stacked
                    seqs = [[] if isinstance(t, SeqValue) else None
                            for t in fetches]
                    outs = [None if isinstance(t, SeqValue) else
                            torch.empty((K,) + tuple(t.shape),
                                        dtype=t.dtype, device=t.device)
                            for t in fetches]
                for o, sq, t in zip(outs, seqs, fetches):
                    if sq is None:
                        o[j].copy_(t)
                    elif self.device.type == 'cuda':
                        # every replay writes the same static buffers
                        sq.append(map_value(torch.clone, t))
                    else:
                        sq.append(t)
                if health is not None:
                    h = health if isinstance(health, torch.Tensor) \
                        else _pack_health(health)
                    if hbuf is None:
                        hbuf = torch.empty((K,) + tuple(h.shape),
                                           dtype=h.dtype, device=h.device)
                    hbuf[j].copy_(h)
            if hbuf is not None:
                with (obs.span('executor.host_stall', cause='anomaly_guard',
                               steps=K)
                      if sync == 'async' else contextlib.nullcontext()):
                    hs = health_to_numpy(hbuf)
                for j in range(K):
                    self._observe_health(
                        program, {k: v[j] for k, v in hs.items()},
                        run_id=run_base + j + 1)
            with obs.span('executor.fetch', sync=sync, steps=K):
                lazy = sync == 'async'
                dense = iter(self._convert_fetches(
                    program, [o for o in outs if o is not None],
                    return_numpy, lazy))
                return [next(dense) if sq is None else
                        self._convert_fetches(program, sq, return_numpy, lazy)
                        for sq in seqs]

    def _observe_health(self, program, h, run_id=None):
        """The guard's host side (the JAX :1854): record the health vector
        (numpy), count skips, warn per skipped step and raise
        FloatingPointError at max_consecutive_skips."""
        self.last_step_health = h
        if run_id is None:
            run_id = self._run_counter
        _G_GRAD_NORM.set(float(h['grad_norm']))
        if bool(h['healthy']):
            self._consecutive_skips = 0
            return
        self.skipped_steps += 1
        self._consecutive_skips += 1
        _C_SKIPPED.inc()
        obs.event('anomaly.skip', run=run_id,
                  grad_norm=float(h['grad_norm']),
                  loss_finite=bool(h['loss_finite']),
                  grads_finite=bool(h['grads_finite']),
                  consecutive=self._consecutive_skips)
        warnings.warn(
            'anomaly guard: step %d skipped (loss_finite=%s grads_finite=%s '
            'grad_norm=%s): parameters and optimizer state were rolled '
            'back' % (run_id, bool(h['loss_finite']),
                      bool(h['grads_finite']), float(h['grad_norm'])),
            RuntimeWarning, stacklevel=3)
        max_skips = getattr(program, '_anomaly_guard_max_skips', None)
        if max_skips is not None and self._consecutive_skips >= max_skips:
            raise FloatingPointError(
                'anomaly guard: %d consecutive unhealthy steps (limit %d): '
                'the run has diverged, not hit a transient; last health: %r'
                % (self._consecutive_skips, max_skips,
                   {k: np.asarray(v).tolist() for k, v in h.items()}))

    def state_dict(self, program=None, scope=None):
        """{name: tensor} of every scope-initialized persistable of
        `program` (the JAX :1955); a LoD (SeqValue) persistable is skipped
        with a warning."""
        program = program if program is not None else default_main_program()
        scope = scope if scope is not None else global_scope()
        out = {}
        for v in program.list_vars():
            if v.persistable:
                val = scope._chain_get(v.name)
                if isinstance(val, SeqValue):
                    # as the JAX state_dict (:1963-1978): LoD state has no
                    # place in the state dict; the npz path (io) saves it
                    warnings.warn('state_dict skips LoD persistable %r'
                                  % v.name, RuntimeWarning)
                    continue
                if val is not None:
                    out[v.name] = val
        return out

    def load_state_dict(self, state, program=None, scope=None):
        """Restore a state_dict into the scope on the executor's device
        (the JAX :1986). Entries that are not persistables of the program
        are skipped with a warning; persistables absent from `state` keep
        their values. A captured step copies each restored value into its
        static state before its next replay. Returns the restored names."""
        program = program if program is not None else default_main_program()
        scope = scope if scope is not None else global_scope()
        pvars = {v.name for v in program.list_vars() if v.persistable}
        restored, unknown = [], []
        for name, val in state.items():
            if name not in pvars:
                unknown.append(name)
                continue
            t = val if isinstance(val, torch.Tensor) else \
                torch.from_numpy(np.array(val, copy=True))
            scope._chain_set(name, t.detach().to(self.device).clone())
            restored.append(name)
        if unknown:
            warnings.warn(
                'load_state_dict: %d entr(ies) are not persistables of this '
                'program and were skipped: %s'
                % (len(unknown), sorted(unknown)[:8]), RuntimeWarning)
        obs.event('executor.load_state_dict', restored=len(restored),
                  skipped=len(unknown))
        return restored

    @property
    def cache_stats(self):
        """THIS executor's artifact cache: hits, misses, entries,
        evictions (close() drops), captures (one per signature and scope)
        and replays of captured graphs."""
        return {'hits': self._cache_hits,
                'misses': self._cache_misses,
                'entries': len(self._cache),
                'evictions': self._cache_evictions,
                'captures': self._captures,
                'replays': self._replays}

    @staticmethod
    def _to_numpy(t):
        a = numpy_of(t.detach().cpu())
        # a CPU tensor's numpy view would alias scope or cached state
        return a.copy() if t.device.type == 'cpu' else a

    def close(self):
        """Drop every artifact and its captured graphs."""
        with self._lock:
            self._cache_evictions += len(self._cache)
            _C_EVICTIONS.inc(len(self._cache))
            self._cache.clear()
