"""The compiled step: ONE artifact per (program, feed signature, fetch set)
that every step entry point runs.

Parity: the JAX package's fluid/step_artifact.py (StepArtifact :75). There
the step is one jitted XLA module per signature; here, on a CUDA place, it
is one captured CUDA graph per signature, and on the CPU the same
artifact runs its eager body, as JAX's jit does there. The four entry
points of fluid/executor.py (`Executor.run`, `run_bundle`,
`StepHandle.step` and the serving dispatch through Predictor.run) all
build through `Executor._prepare` and run the artifact it returns.

The artifact owns

  * the step body: the op walk (`_run_ops`), the training split at the
    `autodiff` op (`_train_step`: forward, torch.autograd.grad, the
    sparse taps of `_sparse_embedding_plan`, the optimizer rules), the
    anomaly guard's health vector (`_step_health`) and its rollback
    (`_select_healthy`);
  * the memory plan (fluid/passes/memplan.py): which persistables the
    step writes and which it only reads;
  * on the card, per scope, the captured graph (`_Captured`) with its
    static feed buffers, the static state it reads and updates in place
    (the scope's own tensors: `pin_state`), its fetch outputs and the
    kernel launches it makes per replay.

On the card a signature's FIRST call is its warm-up (repeated while a
call changes the dtype or shape of a persistable it writes, as a
bf16-declared parameter's first update does): the body runs
eagerly on the executor's side stream under torch's sync debug mode
('error'), building each kernel at first use (ops/_cuda.py), filling the
lowering's constant cache and finding any host sync. That call is the
counterpart of JAX's first-call compile. The sync debug mode is
process-wide: while a warm-up runs, another thread's host sync raises as
well, so warm serving engines up before traffic (their warmup() does).
The SECOND call captures the body into a torch.cuda.CUDAGraph (forward,
autograd, sparse taps and updates, whole) over static feed, seed and
state tensors, then replays it; every
later call copies the feeds in, sets the seed and replays. A body that
cannot be captured raises RuntimeError naming the op the walk was at; there
is no eager fallback. The eager walk (`debug_step`) runs on the card only
when fluid.debugger.check_nan_inf() is active.

Random ops draw from the executor's torch.Generator, which every graph
registers (CUDAGraph.register_generator_state): a replay reads the
generator's seed and offset as they stand when it launches, so
`manual_seed(seed)` before a replay gives captured run j the masks of
eager run j.

A replay runs no Python, so the launch counters of ops/_cuda.py cannot
count it: each graph records the launches its capture saw
(`_cuda.launch_counts`), takes them back (the capture launched nothing)
and adds them on every replay.

On a dp mesh (Program.set_mesh, ParallelExecutor, DistributeTranspiler)
the artifact carries a mesh_step.MeshPlan: each rank runs the step on its
rows, the ops that mix batch rows complete across the ranks, the gradients
are averaged in buckets between torch.autograd.grad and the update rules,
ZeRO blocks are gathered, reduce-scattered and updated locally, and
batch-sharded fetches are gathered; on the card all of it is captured into
the one graph.

Not ported (ROADMAP.md Queue A): the AOT manifest and warm signatures
(write_aot, read_aot, aot_check), the tensor, sequence and pipeline
shardings and the pipeline region, remat.
"""
import hashlib
import json
import time
import weakref

import numpy as np
import torch
from torch.profiler import record_function

from ..ops import _cuda
from .lowering import (Ctx, SeqValue, SparseRows, data_of, leaves_of, like,
                       map_value, run_op)
from .mesh_step import MeshPlan
from .ops_impl.block_ops import check_loops, pack_loops
from .passes import memory_plan

__all__ = ['StepArtifact', 'ExportedStep', 'program_fingerprint',
           'stable_signature']


def _dtype_name(dtype):
    return str(dtype).replace('torch.', '')


def _feed_signature(name, val):
    """(name, shape, dtype) of a feed value after the executor's dtype
    coercion: the part of the cache key a feed decides. A SeqValue's is
    (name, 'seq', then (shape, dtype) of its data, its lengths and each
    outer level): one artifact, and on the card one captured graph, per
    time bucket; lengths that differ within a bucket replay it."""
    if isinstance(val, SeqValue):
        return (name, 'seq') + tuple(
            (tuple(int(d) for d in t.shape), _dtype_name(t.dtype))
            for t in leaves_of(val))
    return (name, tuple(int(d) for d in val.shape), _dtype_name(val.dtype))


def _static_feed(sig, device):
    """An empty feed buffer of signature `sig` (_feed_signature's) on
    `device`: a tensor, or a SeqValue of one buffer a leaf."""
    if sig[1] == 'seq':
        leaves = [torch.empty(shape, dtype=getattr(torch, dtype),
                              device=device) for shape, dtype in sig[2:]]
        return SeqValue(leaves[0], leaves[1], leaves[2:] or None)
    return torch.empty(sig[1], dtype=getattr(torch, sig[2]), device=device)


def _to_card(v, device):
    """A feed value on `device`: each CPU tensor through pinned memory,
    without a host sync."""
    return map_value(lambda t: t.pin_memory().to(device, non_blocking=True)
                     if t.device.type == 'cpu' else t, v)


def _detach(v):
    return map_value(torch.Tensor.detach, v) \
        if isinstance(v, (torch.Tensor, SeqValue)) else v


# optimizer ops with a SparseRows gradient branch (ops_impl/optim_ops.py)
_SPARSE_OPTS = frozenset(['sgd', 'adagrad', 'adam'])


def _sparse_embedding_plan(ops, ad_idx, persistable, fetch_names):
    """Which embedding tables take the sparse gradient path (the JAX
    StepArtifact._sparse_embedding_plan :325, unsharded case).

    A table W qualifies when every reader of W other than its optimizer op
    is an is_sparse lookup_table, W@GRAD is read by exactly one sgd,
    adagrad or adam op and by nothing else, and W@GRAD has no writer, is
    not persistable and is not fetched (fetching it asks for the dense
    gradient). Any other table keeps the dense path.
    Returns {w_name: {'lookups': [(op_idx, ids_name, padding_idx)],
                      'gname': str, 'opt_idx': int}}."""
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
            plan[w] = {'lookups': sorted(lookups), 'gname': gname,
                       'opt_idx': opt_idx}
    return plan


def _nan_inf_hook(i, op, dt, env):
    """debug_step's per-op check (the JAX module's :1132): the first
    floating output holding a NaN or an Inf raises, naming the op."""
    for vs in op.outputs.values():
        for v in vs:
            val = data_of(env.get(v.name))
            if isinstance(val, SparseRows):
                val = val.rows
            if (isinstance(val, torch.Tensor) and val.is_floating_point()
                    and not bool(torch.isfinite(val).all())):
                raise FloatingPointError(
                    "NaN/Inf in output %r of op #%d %r" % (v.name, i,
                                                           op.type))


class _Captured(object):
    """One scope's captured graph of an artifact: the graph, the static
    feed buffers and state tensors it reads (state: the scope's own
    tensors, updated in place by the graph), its fetch and health outputs
    (in the executor's graph pool: valid until the next replay), and the
    kernel launches one replay makes."""

    __slots__ = ('graph', 'feeds', 'state', 'fetches', 'health',
                 'launches', 'loops', '__weakref__')

    def __init__(self):
        self.graph = None


class StepArtifact(object):
    """One (program, feed signature, fetch set) step; see the module
    docstring."""

    def __init__(self, program, feed_names, fetch_names, persist_in,
                 guard=False, amp=False, mesh=None, sharded_feeds=()):
        self.program = program
        # AMP (fluid/amp.py): the rules' Ctx.amp, part of the artifact's
        # key. A program the AMP pass rewrote (`_amp_ir`) carries its casts
        # as ops and runs with it off, even under amp_guard: its bf16
        # operands reach the bf16 kernels and products by their dtype
        self.amp = bool(amp) and not getattr(program, '_amp_ir', False)
        self.ops = list(program.global_block().ops)
        self.feed_names = list(feed_names)
        self.fetch_names = list(fetch_names)
        self.persist_in = list(persist_in)
        # the anomaly guard (executor.anomaly_guard): on training steps
        # only, since only they have gradients to check and updates to skip
        self.guard = bool(guard)
        # set by Executor._prepare: the feed signature the artifact is keyed
        # on, its short key id and the program it was built from
        self._feed_sig = None
        self._key_id = None
        self._source_program = None
        self._stable_sig = None
        ad = [i for i, op in enumerate(self.ops) if op.type == 'autodiff']
        if len(ad) > 1:
            raise ValueError('at most one append_backward per program; '
                             'this one has %d autodiff ops' % len(ad))
        self.ad_idx = ad[0] if ad else None
        self.persistables = sorted({v.name for v in program.list_vars()
                                    if v.persistable})
        # mesh: a mesh_step.MeshSpec. A replicated is_sparse table takes
        # its dense, all-reduced gradient under a mesh (the JAX :357-384)
        self.mesh = None if mesh is None else MeshPlan(
            mesh, self.ops, self.ad_idx, sharded_feeds, fetch_names)
        self.sparse_plan = {} if self.ad_idx is None or mesh is not None \
            else _sparse_embedding_plan(self.ops, self.ad_idx,
                                        set(self.persistables),
                                        set(fetch_names))
        self.plan = memory_plan(program)
        self.mutates_persist = self.plan.donates
        self.donate_names = self.plan.donate_names(self.persist_in)
        self.readonly_names = self.plan.readonly_names(self.persist_in)
        self.persist_out = self.plan.persist_out()
        self._bundles = set()
        self._captured = weakref.WeakKeyDictionary()   # scope -> _Captured
        self.captures = 0
        self.replays = 0
        self._at = None     # (op index, type) the walk is at
        # the while ops' end flags of the last step (block_ops.pack_loops),
        # which check_loops reads on the host after the step
        self.last_loops = None

    # -- the step body ---------------------------------------------------

    def _run_ops(self, env, lo, hi, ctx, grad_mode=False, on_op=None,
                 taps=None, update=False):
        """Run ops [lo, hi) against env. grad_mode: every output var marked
        stop_gradient is detached (the JAX _run_ops :591-596). taps: {op
        index: (tap tensor, output name)}: right after that op the tap is
        added to its output, so the tap's gradient is the per-row gradient
        there (:586-590). on_op(i, op, seconds, env): each op is
        synchronized and timed, and the hook runs after it. update: the ops
        after the autodiff op (on a mesh, ZeRO blocks update locally)."""
        mesh = self.mesh
        for i in range(lo, hi):
            op = self.ops[i]
            if op.type == 'autodiff':
                continue
            self._at = (i, op.type)
            t0 = time.perf_counter() if on_op is not None else None
            if mesh is None:
                run_op(op, env, ctx)
            else:
                mesh.run_op(i, op, env, ctx, update)
            if on_op is not None:
                if ctx.device.type == 'cuda':
                    torch.cuda.synchronize(ctx.device)
                on_op(i, op, time.perf_counter() - t0, env)
            if taps is not None and i in taps:
                tap, out = taps[i]
                env[out] = like(env[out], data_of(env[out]) + tap)
            if grad_mode:
                for vs in op.outputs.values():
                    for v in vs:
                        if v.stop_gradient and v.name in env:
                            env[v.name] = _detach(env[v.name])

    def _body(self, persist, feed, ctx, on_op=None, check_nan_inf=False):
        """The step: (fetches, new persistables, health or None). Pure but
        for the sparse optimizer rules, which update their table and
        moments in place. The while ops' end flags go to last_loops."""
        loops = []
        ctx = ctx.derive(loops=loops)
        env = dict(persist)
        env.update(feed)
        health = None
        if self.ad_idx is None:
            mode = torch.no_grad() if self.plan.donates \
                else torch.inference_mode()
            with mode:
                if self.mesh is not None:
                    self.mesh.gather_placed(env, {})
                self._run_ops(env, 0, len(self.ops), ctx, on_op=on_op)
                if self.mesh is not None:
                    self.mesh.cut_placed(env, {})
            old = persist
        else:
            health, old = self._train_step(env, persist, ctx, on_op,
                                           check_nan_inf)
        fetches = [env[n] for n in self.fetch_names]
        if self.mesh is not None:
            fetches = self.mesh.gather_fetches(fetches, env)
        new_persist = {n: env[n] for n in self.persist_out if n in env}
        if health is not None:
            with torch.no_grad():
                self._select_healthy(health['healthy'], new_persist, old)
        self.last_loops = pack_loops(loops)
        return fetches, new_persist, health

    def _train_step(self, env, persist, ctx, on_op, check_nan_inf):
        """The step of a program with an autodiff op: the counterpart of
        the JAX StepArtifact's _grad_setup / _make_fwd / _apply_grads
        (:412-501). Returns (health or None, the pre-update persistables
        the guard rolls back to)."""
        ops = self.ops
        ad = ops[self.ad_idx]
        gnames = dict(zip(ad.attrs['param_names'], ad.attrs['grad_names']))
        # the planned tables whose ids are known before the forward runs
        # (fed or persistable), which the taps' shapes need; the others
        # stay dense
        sparse = {w: p for w, p in self.sparse_plan.items()
                  if w in env and all(ids in env
                                      for _, ids, _ in p['lookups'])}
        taps = {}
        for w, p in sparse.items():
            d = env[w].shape[-1]
            for op_idx, ids_name, _ in p['lookups']:
                shape = tuple(data_of(env[ids_name]).shape)
                if shape and shape[-1] == 1:
                    shape = shape[:-1]
                taps[op_idx] = (torch.zeros(shape + (d,),
                                            dtype=env[w].dtype,
                                            device=env[w].device,
                                            requires_grad=True),
                                ops[op_idx].outputs['Out'][0].name)
        pnames = [n for n in ad.attrs['param_names']
                  if n in env and n not in sparse]
        leaves = [env[n].detach().requires_grad_() for n in pnames]
        env.update(zip(pnames, leaves))
        mesh = self.mesh
        placed = {} if mesh is None else {
            n: leaf for n, leaf in zip(pnames, leaves) if n in mesh.placement}
        if mesh is not None:
            # ZeRO blocks become full values for the forward
            mesh.gather_placed(env, placed)
        tap_order = sorted(taps)
        # record_function ranges name the phases in a torch.profiler trace
        # (tools/torch_train_profile.py); without a profiler they cost ~1 us
        with torch.enable_grad():
            with record_function('executor.forward'):
                self._run_ops(env, 0, self.ad_idx, ctx, grad_mode=True,
                              on_op=on_op, taps=taps)
                loss = env[ad.attrs['loss_name']].to(torch.float32).sum()
            self._at = (self.ad_idx, 'autodiff')
            grads = torch.autograd.grad(
                loss, leaves + [taps[i][0] for i in tap_order],
                allow_unused=True)
        scale = ad.attrs.get('loss_scale', 1.0)
        for n in list(env):
            env[n] = _detach(env[n])
        if mesh is not None:
            mesh.cut_placed(env, placed)
        for n, leaf, g in zip(pnames, leaves, grads):
            if g is None:          # the loss does not reach this parameter
                g = torch.zeros_like(leaf)
            if scale != 1.0:
                g = g * scale
            g = g.to(leaf.dtype)
            if check_nan_inf and not bool(torch.isfinite(g).all()):
                raise FloatingPointError(
                    "NaN/Inf in gradient %r (of parameter %r)"
                    % (gnames[n], n))
            env[gnames[n]] = g
        if mesh is not None:
            # the gradients of replicated parameters, averaged over the
            # ranks (a ZeRO-3 block's came averaged out of its gather)
            mesh.reduce_grads(env, [gnames[n] for n in pnames
                                    if n not in placed])
        tap_grads = dict(zip(tap_order, grads[len(leaves):]))
        for w, p in sparse.items():
            d = env[w].shape[-1]
            ids_parts, row_parts = [], []
            n = env[w].shape[0]
            for op_idx, ids_name, pad in p['lookups']:
                ids = data_of(env[ids_name]).reshape(-1).long()
                g = tap_grads[op_idx]
                rows = torch.zeros((ids.shape[0], d), dtype=env[w].dtype,
                                   device=ids.device) if g is None \
                    else g.reshape(-1, d)
                # the lookup's id rule (sequence_ops.lookup_table): an id in
                # [-V, 0) counts from the end; any other id outside [0, V)
                # read a NaN row and updates nothing (JAX drops its
                # out-of-range scatter): it goes to row 0 with a zero row,
                # on the device, so no kernel indexes past the table. A
                # zero row leaves SGD and Adagrad exactly as they were;
                # lazy Adam decays row 0's moments, in a step whose loss is
                # NaN (which the anomaly guard skips whole)
                ids = torch.where(ids < 0, ids + n, ids)
                live = (ids >= 0) & (ids < n)
                rows = rows.masked_fill(~live[:, None], 0.0)
                ids = torch.where(live, ids, torch.zeros_like(ids))
                if pad is not None and pad >= 0:
                    # the dense gradient's padding_idx row is zero (the
                    # lookup reads that row as zeros); mirror it on the rows
                    rows = rows.masked_fill((ids == pad)[:, None], 0.0)
                ids_parts.append(ids)
                row_parts.append(rows)
            rows = torch.cat(row_parts)
            if scale != 1.0:
                rows = rows * scale
            rows = rows.to(env[w].dtype)
            if check_nan_inf and not bool(torch.isfinite(rows).all()):
                raise FloatingPointError(
                    "NaN/Inf in gradient %r (of parameter %r)"
                    % (gnames[w], w))
            env[p['gname']] = SparseRows(torch.cat(ids_parts), rows,
                                         env[w].shape)
        health = None
        old = persist
        if self.guard:
            health = self._step_health(env, ad, pnames, gnames, sparse)
            # the sparse rules update their table and moments in place:
            # keep the values the guard rolls back to
            inplace = {n for p in sparse.values()
                       for n in ops[p['opt_idx']].output_arg_names
                       if n in persist}
            if inplace:
                old = dict(persist)
                old.update((n, persist[n].clone()) for n in inplace)
        with torch.no_grad(), record_function('executor.update'):
            self._run_ops(env, self.ad_idx + 1, len(ops), ctx, on_op=on_op,
                          update=True)
        return health, old

    def _step_health(self, env, ad, pnames, gnames, sparse):
        """The health vector (the JAX StepArtifact's :503): finiteness of
        the loss and of every gradient (dense and sparse rows) and the
        global gradient norm, as device reductions over values the
        backward already produced."""
        loss = env[ad.attrs['loss_name']]
        loss_finite = torch.isfinite(loss.to(torch.float32)).all()
        grads_finite = torch.ones((), dtype=torch.bool, device=loss.device)
        sq = torch.zeros((), dtype=torch.float32, device=loss.device)
        # on a mesh, a gradient held as this rank's block adds its part of
        # the norm and of the finiteness across the ranks
        part = torch.zeros(2, dtype=torch.float32, device=loss.device)
        mesh = self.mesh
        for n in list(pnames) + list(sparse):
            g = env.get(gnames[n])
            if g is None:
                continue
            gf = (g.rows if isinstance(g, SparseRows) else g).to(
                torch.float32)
            if mesh is not None and (n in mesh.placement
                                     or gnames[n] in mesh.scatter_grads):
                part = part + torch.stack([
                    (gf * gf).sum(), (~torch.isfinite(gf)).sum().float()])
                continue
            grads_finite = grads_finite & torch.isfinite(gf).all()
            sq = sq + (gf * gf).sum()
        if mesh is not None and (mesh.placement or mesh.scatter_grads):
            part = mesh.global_sum(part)
            sq = sq + part[0]
            grads_finite = grads_finite & (part[1] == 0)
        return {'healthy': loss_finite & grads_finite,
                'loss_finite': loss_finite, 'grads_finite': grads_finite,
                'grad_norm': torch.sqrt(sq)}

    @staticmethod
    def _select_healthy(healthy, new_persist, old):
        """The skip policy (the JAX :530): on an unhealthy step every
        written persistable keeps its pre-step value, bit for bit, through
        a predicated select."""
        for n in list(new_persist):
            o = old.get(n)
            new = new_persist[n]
            if (o is None or new is o or not isinstance(new, torch.Tensor)
                    or new.shape != o.shape):
                continue
            new_persist[n] = torch.where(healthy, new, o)

    def debug_step(self, persist, feed, seed, check_nan_inf=False,
                   on_op=None, generator=None):
        """The eager walk (the JAX :717): per-op NaN/Inf checks raising
        FloatingPointError that names the op, and per-op wall times for an
        `on_op(i, op, seconds, env)` hook. `feed`: tensors on the step's
        device; random ops draw from `generator` (default: a new one on
        that device) seeded with `seed`. Returns (fetches, new
        persistables, health) and leaves `persist` to the caller (the
        sparse rules update their tables in place)."""
        hooks = ([on_op] if on_op is not None else []) + \
            ([_nan_inf_hook] if check_nan_inf else [])

        def hook(i, op, dt, env):
            for h in hooks:
                h(i, op, dt, env)

        if generator is None:
            tensors = [t for t in list(persist.values()) + list(feed.values())
                       if isinstance(t, torch.Tensor)]
            generator = torch.Generator(
                device=tensors[0].device if tensors else 'cpu')
        generator.manual_seed(seed)
        ctx = Ctx(generator.device, generator, amp=self.amp)
        out = self._body(persist, feed, ctx, on_op=hook if hooks else None,
                         check_nan_inf=check_nan_inf)
        check_loops(self.last_loops)
        return out

    def __call__(self, persist, feed, seed, generator):
        """One eager step (the CPU's path, as JAX's jit runs on the CPU)."""
        generator.manual_seed(seed)
        return self._body(persist, feed,
                          Ctx(generator.device, generator, amp=self.amp))

    # -- the captured step on the card -------------------------------------

    def pin_state(self, scope, device):
        """Make every persistable the step reads a contiguous tensor on
        `device` that shares storage with no other persistable of the step,
        rebinding the scope where it was not: a captured graph reads and
        updates these tensors by address, so they are its static state.
        Returns the names rebound (the JAX :772 returns the names it
        re-placed)."""
        pinned, seen = [], set()
        for n in self.persistables:
            v = scope._chain_get(n)
            if v is None or isinstance(v, SeqValue):
                continue
            t = torch.as_tensor(v)
            if (t.device != device or not t.is_contiguous()
                    or t.requires_grad or t.is_inference()
                    or (t.numel() and t.data_ptr() in seen)):
                t = t.detach().to(device).contiguous().clone()
            if t is not v:
                scope._chain_set(n, t)
                pinned.append(n)
            if t.numel():
                seen.add(t.data_ptr())
        return pinned

    def run_captured(self, exe, scope, feed, seed):
        """One step on the card: the signature's warm-up on its first call
        for this scope, its capture and first replay on the second, a
        replay after. `feed`: name -> CPU or device tensor of the
        artifact's signature. Returns (fetches, health): on a replay the
        graph's outputs, valid until the executor's next replay; the caller
        copies them out under the executor's lock."""
        rec = self._captured.get(scope)
        if rec is None:
            before = _state_signature(self._scope_state(scope))
            out = self._warm_up(exe, scope, feed, seed)
            # a step that changed the dtype or shape of a persistable (a
            # bf16-declared parameter that its update writes back in fp32,
            # as the JAX rules' promotion does) is warmed up again: a
            # capture needs the state it updates in place to keep its
            # dtypes and shapes
            if _state_signature(self._scope_state(scope)) == before:
                self._captured[scope] = _Captured()
            return out
        if rec.graph is None:
            self._capture(exe, scope, rec)
        else:
            self._sync_state(exe, scope, rec)
        for n, v in feed.items():
            for dst, t in zip(leaves_of(rec.feeds[n]), leaves_of(v)):
                dst.copy_(t.pin_memory() if t.device.type == 'cpu' else t,
                          non_blocking=True)
        exe._generator.manual_seed(seed)
        rec.graph.replay()
        _cuda.add_launches(rec.launches)
        self.replays += 1
        exe._replays += 1
        self.last_loops = rec.loops
        return rec.fetches, rec.health

    def _warm_up(self, exe, scope, feed, seed):
        """The eager first call of a signature on the executor's side
        stream, under torch's sync debug mode: a host sync in the body
        raises here, before any capture."""
        dev = exe.device
        self.pin_state(scope, dev)
        side = exe._side_stream()
        side.wait_stream(torch.cuda.current_stream(dev))
        prev = torch.cuda.get_sync_debug_mode()
        try:
            with torch.cuda.stream(side):
                persist = self._scope_state(scope)
                feed = {n: _to_card(v, dev) for n, v in feed.items()}
                self._at = None
                torch.cuda.set_sync_debug_mode('error')
                try:
                    fetches, new_persist, health = self(
                        persist, feed, seed, exe._generator)
                except RuntimeError as e:
                    if 'synchronizing CUDA operation' not in str(e):
                        raise
                    raise RuntimeError(
                        'the step cannot be captured into a CUDA graph: op '
                        '#%s %r waits for the card (%s)'
                        % (self._at[0] if self._at else '?',
                           self._at[1] if self._at else None, e)) from e
                torch.cuda.set_sync_debug_mode(prev)
                _write_back(scope, new_persist, in_place=True)
        finally:
            torch.cuda.set_sync_debug_mode(prev)
        cur = torch.cuda.current_stream(dev)
        cur.wait_stream(side)
        for v in fetches + list((health or {}).values()):
            for t in leaves_of(v):
                if isinstance(t, torch.Tensor) and t.device.type == 'cuda':
                    t.record_stream(cur)
        return fetches, health

    def uninitialized(self, scope):
        """The persistables the step writes that have no value in `scope`
        yet (a startup program's outputs)."""
        return sorted(n for n in self.plan.write_set
                      if scope._chain_get(n) is None)

    def _scope_state(self, scope):
        state = {}
        for n in self.persistables:
            v = scope._chain_get(n)
            if v is not None and n not in self.feed_names:
                state[n] = v
        return state

    def _capture(self, exe, scope, rec):
        """Capture the body into a CUDA graph over static feeds and the
        scope's (pinned) state, in the executor's graph pool."""
        dev = exe.device
        self.pin_state(scope, dev)
        sig = dict((s[0], s) for s in self._feed_sig or ())
        feeds = {n: _static_feed(sig[n], dev) for n in self.feed_names}
        state = self._scope_state(scope)
        side = exe._side_stream()
        torch.cuda.synchronize(dev)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(exe._generator)
        before = _cuda.launch_counts()
        self._at = None
        try:
            with torch.cuda.stream(side):
                graph.capture_begin(pool=exe._graph_pool,
                                    capture_error_mode='thread_local')
                try:
                    fetches, new_persist, health = self._body(
                        state, feeds, Ctx(dev, exe._generator, amp=self.amp))
                    moved = [n for n, v in new_persist.items()
                             if n in state and (v.shape != state[n].shape
                                                or v.dtype != state[n].dtype)]
                    if moved:
                        raise RuntimeError(
                            'persistables %r change dtype or shape in the '
                            'step' % moved[:4])
                    _write_back_static(state, new_persist)
                    if health is not None:
                        health = _pack_health(health)
                except BaseException as e:
                    _abort_capture(graph, dev)
                    exe._graphs.discard(rec)
                    at = self._at
                    raise RuntimeError(
                        'the step cannot be captured into a CUDA graph: it '
                        'failed at op #%s %r (%s: %s)' % (
                            at[0] if at else '?', at[1] if at else None,
                            type(e).__name__, e)) from e
                graph.capture_end()
        finally:
            # the capture launched nothing: take back what it counted;
            # every replay adds it
            after = _cuda.launch_counts()
            rec.launches = {k: after[k] - before.get(k, 0) for k in after
                            if after[k] != before.get(k, 0)}
            _cuda.add_launches({k: -n for k, n in rec.launches.items()})
        torch.cuda.current_stream(dev).wait_stream(side)
        rec.graph, rec.feeds, rec.state = graph, feeds, state
        rec.fetches, rec.health = fetches, health
        rec.loops = self.last_loops
        self.captures += 1
        exe._captures += 1
        exe._graphs.add(rec)

    def _sync_state(self, exe, scope, rec):
        """Before a replay: a persistable the scope no longer binds to the
        graph's static tensor (Scope.load_numpy, io.load_persistables, a
        run that rebinds) is copied into it, and the scope binds the
        static tensor again. A changed shape or dtype recaptures."""
        for n, t in rec.state.items():
            v = scope._chain_get(n)
            if v is t:
                continue
            if v is None:
                raise RuntimeError(
                    'persistable %r of a captured step lost its scope '
                    'value' % n)
            v = torch.as_tensor(v)
            if v.shape != t.shape or v.dtype != t.dtype:
                exe._graphs.discard(rec)
                rec.graph = None
                self._capture(exe, scope, rec)
                return
            with torch.no_grad():
                t.copy_(v)
            scope._chain_set(n, t)

    def bundle_signature(self, K):
        """Record that a K-step bundle ran on this artifact."""
        self._bundles.add(int(K))

    # -- first-class artifact surface ---------------------------------------

    def signatures(self):
        """Every entry point this artifact has served: the step, and one
        ('bundle', K) per bundle length (K replays of the step's graph)."""
        return [('step',)] + [('bundle', K) for K in sorted(self._bundles)]

    def touched_rows(self, feed):
        """The rows of each sparse-plan table the step's sparse update will
        write for one fed batch, read on the host from the feed (the JAX
        :811): {table: sorted unique int64 ids}, padding_idx rows left
        out; tables training dense are absent."""
        out = {}
        for w, plan in self.sparse_plan.items():
            parts = []
            n = self.program.global_block().var(w).shape[0]
            for _op_idx, ids_name, pad in plan['lookups']:
                v = data_of(feed.get(ids_name))
                if v is None:
                    parts = None
                    break
                if isinstance(v, torch.Tensor):
                    v = v.detach().cpu().numpy()
                ids = np.asarray(v).reshape(-1)
                # the lookup's id rule: negative ids wrap, ids out of range
                # touch no row
                ids = np.where(ids < 0, ids + n, ids)
                ids = ids[(ids >= 0) & (ids < n)]
                if pad is not None and pad >= 0:
                    ids = ids[ids != pad]
                parts.append(ids.astype(np.int64))
            if parts:
                out[w] = np.unique(np.concatenate(parts))
        return out

    @property
    def state_names(self):
        """The persistables this step reads or writes."""
        return list(self.persist_in)

    def state_dict(self, scope):
        """{name: tensor} of this step's persistable state, read live from
        `scope`."""
        out = {}
        for n in self.persist_in:
            v = scope._chain_get(n)
            if v is not None:
                out[n] = v
        return out


class ExportedStep(StepArtifact):
    """A module that torch.export wrote (inference.load_compiled's
    artifact: the weights are its own buffers) run as a step artifact, so
    on the card it takes the same warm-up, capture and replay as a
    program's step: its one fixed-shape call is warmed up at the first
    call, captured at the second and replayed after that. It has no
    Program and no persistable in a scope; `feed_sig` is the exported
    inputs' (name, shape, dtype) signature, and the body returns the
    module's outputs as the fetches."""

    def __init__(self, module, feed_names, fetch_names, feed_sig):
        # the fields the warm-up, capture and replay read
        self.module = module
        self.amp = False
        self.feed_names = list(feed_names)
        self.fetch_names = list(fetch_names)
        self.persistables = []
        self._feed_sig = tuple(sorted(feed_sig))
        self._captured = weakref.WeakKeyDictionary()
        self.captures = 0
        self.replays = 0
        self._at = None
        self.last_loops = None

    def _body(self, persist, feed, ctx, on_op=None, check_nan_inf=False):
        with torch.inference_mode():
            outs = self.module(*[feed[n] for n in self.feed_names])
        self.last_loops = None
        return list(outs), {}, None


def _state_signature(state):
    """(name, shape, dtype) of each tensor of a step's persistable state."""
    return sorted((n, tuple(v.shape), v.dtype) for n, v in state.items()
                  if isinstance(v, torch.Tensor))


def _write_back(scope, new_persist, in_place):
    """Bind a step's written persistables in the scope: in place into the
    tensors the scope holds (the card's pinned state) where shape and
    dtype allow, else by rebinding."""
    if not in_place:
        for n, v in new_persist.items():
            scope._chain_set(n, v)
        return
    cur = {n: scope._chain_get(n) for n in new_persist}
    _write_back_static(cur, new_persist)
    for n, v in new_persist.items():
        t = cur[n]
        if not (isinstance(t, torch.Tensor) and t.shape == v.shape
                and t.dtype == v.dtype):
            scope._chain_set(n, v)


def _write_back_static(state, new_persist):
    """Copy each new value into its static tensor of `state` (shape and
    dtype permitting). A new value that shares storage with another
    written static tensor is cloned first, so no copy reads a tensor an
    earlier copy overwrote."""
    with torch.no_grad():
        ptrs = {}
        for n in new_persist:
            t = state.get(n)
            if isinstance(t, torch.Tensor) and t.numel():
                ptrs[t.untyped_storage().data_ptr()] = n
        pending = []
        for n, v in new_persist.items():
            t = state.get(n)
            if v is t or not (isinstance(t, torch.Tensor)
                              and isinstance(v, torch.Tensor)
                              and t.shape == v.shape and t.dtype == v.dtype):
                continue
            if v.numel() and ptrs.get(v.untyped_storage().data_ptr(),
                                      n) != n:
                v = v.clone()
            pending.append((t, v))
        if pending:
            # one multi-tensor launch per chunk of tensors, not a copy
            # kernel each (a Transformer step writes back 552 tensors)
            dst, src = zip(*pending)
            torch._foreach_copy_(list(dst), list(src))


_HEALTH_KEYS = ('healthy', 'loss_finite', 'grads_finite', 'grad_norm')


def _pack_health(health):
    """The health dict as one float32 [4] tensor (one copy to the host)."""
    return torch.stack([health[k].to(torch.float32) for k in _HEALTH_KEYS])


def health_to_numpy(health):
    """A health vector (a dict of tensors, or _pack_health's tensor, with
    a leading K axis for a bundle) as a dict of numpy values: bools for the
    flags, float32 for the norm."""
    if isinstance(health, dict):
        health = _pack_health(health)
    h = health.detach().cpu().numpy()
    out = {k: h[..., i] != 0 for i, k in enumerate(_HEALTH_KEYS[:3])}
    out['grad_norm'] = h[..., 3].astype(np.float32)
    return out


def _abort_capture(graph, device):
    """End a capture that failed: the stream leaves capture mode and the
    caching allocator stops routing this thread's allocations to the
    graph's pool, so later captures start clean."""
    try:
        graph.capture_end()
    except Exception:   # noqa: BLE001 - the capture is invalid already
        torch._C._cuda_endAllocateToPool(device.index, graph.pool())
    graph.reset()


def program_fingerprint(program):
    """Process-independent structural identity of a Program: sha256 over
    its canonical dict serialization (the JAX :882)."""
    doc = json.dumps(program._to_dict(), sort_keys=True, default=str)
    return hashlib.sha256(doc.encode('utf-8')).hexdigest()[:16]


def stable_signature(art):
    """Process-independent identity of one step signature (the JAX :892):
    program fingerprint, feed signature, fetch set, persistable set, the
    guard and amp flags. Cached on the artifact."""
    if art._stable_sig is not None:
        return art._stable_sig
    src = art._source_program if art._source_program is not None \
        else art.program
    payload = json.dumps({
        'program': program_fingerprint(src),
        'feed_sig': [[str(x) for x in sig] for sig in (art._feed_sig or ())],
        'fetches': list(art.fetch_names),
        'persist_in': list(art.persist_in),
        'donates': sorted(art.donate_names),
        'guard': bool(art.guard),
        'amp': bool(art.amp),
    }, sort_keys=True)
    art._stable_sig = hashlib.sha256(payload.encode('utf-8')).hexdigest()[:16]
    return art._stable_sig
