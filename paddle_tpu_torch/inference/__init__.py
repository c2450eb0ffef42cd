"""Inference runtime: load a saved inference model and run it.

Parity: reference paddle/fluid/inference and the JAX package's
paddle_tpu.inference (Predictor :26-100, export_compiled :103,
load_compiled :177). There are two artifacts:

1. A program bundle (fluid.io.save_inference_model: the JSON ProgramDesc
   and the persistables) loaded by `Predictor`, which runs it through the
   Executor.
2. A compiled artifact: `export_compiled` traces the pruned program's step
   with torch.export into ONE fixed-shape module that carries its weights
   (`__model__.pt2`, torch.export.save) beside a meta file;
   `load_compiled` serves it in any process with no Program (the
   reference's C-API / inference-library counterpart). The flash-attention
   forward stays in the exported graph as the operator
   `torch.ops.paddle_tpu_torch.flash_attention_lse`, so a loaded artifact
   launches the same kernel on the card. The artifact is exported for one
   device type (the CPU or CUDA), as jax.export serializes for the
   platform it ran on, and load_compiled refuses the other.
"""
import json
import os

import numpy as np
import torch

from ..fluid import core, io
from ..fluid.executor import Executor, Scope

__all__ = ['Predictor', 'export_compiled', 'load_compiled']

_ARTIFACT = '__model__.pt2'
_META = '__model__.meta.json'


class Predictor(object):
    """Load + run a saved inference model (reference: NativePaddlePredictor,
    inference/api/api_impl.cc).

    place None means CUDAPlace(0): without a card the constructor raises;
    pass CPUPlace() to run on the CPU. Thread-safe: the model's variables
    live in a PRIVATE scope passed explicitly to Executor.run, never
    through the process-global scope; the serving engine relies on it."""

    def __init__(self, dirname, place=None):
        self._place = core.CUDAPlace(0) if place is None else place
        self._exe = Executor(self._place)
        self._scope = Scope()
        prog, feeds, fetches = io.load_inference_model(dirname, self._exe,
                                                       scope=self._scope)
        self._program = prog
        self.feed_names = feeds
        self._fetch_vars = fetches

    @property
    def fetch_names(self):
        return [v.name for v in self._fetch_vars]

    @property
    def input_spec(self):
        """{feed name: (shape, dtype str)} from the loaded program; the
        leading batch dim is -1 (any). The serving engine's warmup uses
        this to build per-bucket feeds without an example."""
        blk = self._program.global_block()
        spec = {}
        for n in self.feed_names:
            v = blk.vars.get(n)
            if v is not None:
                spec[n] = (tuple(int(d) for d in v.shape), str(v.dtype))
        return spec

    def run(self, feed):
        """feed: dict name -> ndarray, or LoDTensor / SeqValue for a
        sequence input (a padded ndarray of a sequence input reads as all
        rows full length). Returns the list of fetched ndarrays (a
        sequence fetch as its flat valid rows). On the card each feed signature (batch size) is warmed
        up on its first call and captured into a CUDA graph on its
        second; later calls replay it, and the fetches come back through
        pinned host buffers."""
        return self._exe.run(self._program, feed=feed,
                             fetch_list=self._fetch_vars, scope=self._scope)


class _Step(torch.nn.Module):
    """The pruned program's step as a module for torch.export: the
    persistables it reads are its buffers (so the exported program lifts
    them into its state), the inputs are the feeds in `feed_names` order,
    and the outputs the fetches. A sequence (lod) input arrives dense and
    is read with every row at full length; a sequence fetch leaves as its
    padded data, as in the JAX export."""

    def __init__(self, art, scope, feed_names, lod_feeds, fetch_f32):
        super(_Step, self).__init__()
        self._art = art
        self._feed_names = list(feed_names)
        self._lod_feeds = frozenset(lod_feeds)
        self._fetch_f32 = bool(fetch_f32)
        self._persist = list(art.persist_in)
        for i, n in enumerate(self._persist):
            self.register_buffer('p%d' % i, torch.as_tensor(
                scope._chain_get(n)).detach())

    def forward(self, *feeds):
        from ..fluid.lowering import Ctx, SeqValue, data_of
        persist = {n: getattr(self, 'p%d' % i)
                   for i, n in enumerate(self._persist)}
        feed = {}
        for n, t in zip(self._feed_names, feeds):
            if n in self._lod_feeds:
                t = SeqValue(t, torch.full((t.shape[0],), t.shape[1],
                                           dtype=torch.int64,
                                           device=t.device))
            feed[n] = t
        fetches, _, _ = self._art._body(
            persist, feed, Ctx(feeds[0].device, None, amp=self._art.amp))
        outs = [data_of(f) for f in fetches]
        if self._fetch_f32:
            # Float16Transpiler's contract: bf16 fetches leave as float32
            outs = [o.to(torch.float32) if o.dtype == torch.bfloat16 else o
                    for o in outs]
        return tuple(outs)


def export_compiled(dirname, feed_example, target_vars, executor,
                    main_program=None, scope=None):
    """Trace the pruned inference graph into ONE fixed-shape module.

    feed_example: dict name -> example ndarray fixing shapes and dtypes
    (pass DENSE arrays; sequence (lod) inputs are exported with every row
    treated full-length: pad at inference time). The program is pruned as
    save_inference_model prunes it, run once through `executor` in
    `scope` (default: the global scope), and its step traced by
    torch.export.export on the executor's device, the scope's
    persistables lifted into the exported program's state. Writes
    `__model__.pt2` (torch.export.save) and `__model__.meta.json`
    (feed_names, fetch_names, each input's shape and dtype as exported,
    the device type); returns the artifact's path."""
    from .. import ops  # noqa: F401  (registers the flash-attention op)
    from ..fluid import framework
    from ..fluid.executor import global_scope
    from ..fluid.lowering import data_of

    if main_program is None:
        main_program = framework.default_main_program()
    if scope is None:
        scope = global_scope()
    if not isinstance(target_vars, (list, tuple)):
        target_vars = [target_vars]
    fetch_names = [v.name if isinstance(v, framework.Variable) else str(v)
                   for v in target_vars]
    infer = main_program.clone(for_test=True).prune(target_vars)
    feed_names = sorted(feed_example)
    # run once through the executor: the artifact the trace walks, and the
    # constant rules' values on the executor's device
    executor.run(infer, feed=dict(feed_example), fetch_list=fetch_names,
                 scope=scope)
    art, feed_vals = executor._prepare(infer, dict(feed_example),
                                       fetch_names, scope)
    blk = infer.global_block()
    lod_feeds = [n for n in feed_names
                 if blk.vars.get(n) is not None and blk.vars[n].lod_level]
    module = _Step(art, scope, feed_names, lod_feeds,
                   getattr(infer, '_fetch_f32', False))
    args = tuple(data_of(feed_vals[n]).to(executor.device)
                 for n in feed_names)
    exported = torch.export.export(module, args)
    os.makedirs(dirname, exist_ok=True)
    path = os.path.join(dirname, _ARTIFACT)
    torch.export.save(exported, path)
    # per-input shapes and dtypes AS EXPORTED: load_compiled validates
    # feeds against them instead of failing inside the module
    inputs = {n: {'shape': [int(d) for d in a.shape],
                  'dtype': str(a.dtype).replace('torch.', '')}
              for n, a in zip(feed_names, args)}
    with open(os.path.join(dirname, _META), 'w') as f:
        json.dump({'feed_names': feed_names, 'fetch_names': fetch_names,
                   'inputs': inputs, 'device': executor.device.type}, f)
    return path


def _kind(dtype):
    """numpy's dtype kind of a dtype name ('f' for bfloat16, which numpy
    does not know)."""
    return 'f' if dtype == 'bfloat16' else np.dtype(dtype).kind


def _validated(name, val, spec):
    """One feed as the exported input takes it: a CPU tensor of the
    exported shape and dtype, or a ValueError naming the input (the JAX
    load_compiled's messages). Safe casts and same-kind narrowing
    (int64 -> int32, float64 -> float32 or bfloat16) are accepted; a
    cast across kinds is not."""
    a = np.asarray(val)
    want_shape = tuple(spec['shape'])
    want = spec['dtype']
    if str(a.dtype) != want:
        if want == 'bfloat16':
            ok = a.dtype.kind == 'f'
        else:
            ok = np.can_cast(a.dtype, np.dtype(want), 'safe') or (
                a.dtype.kind == _kind(want)
                and np.can_cast(a.dtype, np.dtype(want), 'same_kind'))
        if not ok:
            raise ValueError(
                'input %r: dtype %s cannot safely cast to the exported '
                'dtype %s' % (name, a.dtype, want))
    if tuple(a.shape) != want_shape:
        raise ValueError(
            'input %r: shape %r does not match the exported shape %r '
            '(the compiled artifact is fixed-shape; pad/bucket the feed, '
            'e.g. via paddle_tpu_torch.serving)'
            % (name, tuple(a.shape), want_shape))
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(getattr(torch, want))


class CompiledModel(object):
    """A loaded export_compiled artifact (load_compiled's runner):
    `run(feed)` or a call with the feed dict -> [ndarray], with
    `feed_names`, `fetch_names` and `input_spec` ({name: (shape, dtype)},
    the exported, fixed shapes). The weights are part of the artifact:
    there is no scope to push rows into (ServingEngine.push_rows raises
    DeltaUnsupported); publish a new artifact and Router.swap() to it.

    Its one call signature is a step artifact (fluid/step_artifact.py
    ExportedStep) on an Executor of `place`: on the card the first call
    warms it up, the second captures it into a CUDA graph, and later calls
    replay it, the fetches coming back through pinned host buffers.
    Thread-safe: calls serialize on the executor."""

    def __init__(self, dirname, place=None):
        from .. import ops  # noqa: F401  (registers the flash-attention op)
        from ..fluid.step_artifact import ExportedStep
        with open(os.path.join(dirname, _META)) as f:
            meta = json.load(f)
        place = core.CUDAPlace(0) if place is None else place
        device = place.torch_device()
        exported_on = meta.get('device', 'cpu')
        if device.type != exported_on:
            raise ValueError(
                'the artifact under %r was exported for %s and cannot run '
                'on %s (%r): export it again on the device that serves it'
                % (dirname, exported_on, device.type, place))
        self.feed_names = list(meta['feed_names'])
        self.fetch_names = list(meta['fetch_names'])
        self._inputs = meta['inputs']
        self.input_spec = {n: (tuple(s['shape']), s['dtype'])
                           for n, s in self._inputs.items()}
        ep = torch.export.load(os.path.join(dirname, _ARTIFACT))
        module = ep.module().to(device)
        self._executor = Executor(place)
        self._holder = Scope()     # the artifact's capture key: no state
        self._step = ExportedStep(
            module, self.feed_names, self.fetch_names,
            [(n, tuple(s['shape']), s['dtype'])
             for n, s in self._inputs.items()])

    def run(self, feed):
        missing = [n for n in self.feed_names if n not in feed]
        if missing:
            raise ValueError(
                'missing input(s) %r; the artifact expects exactly %r'
                % (missing, self.feed_names))
        extra = sorted(set(feed) - set(self.feed_names))
        if extra:
            raise ValueError(
                'unknown input(s) %r; the artifact expects exactly %r'
                % (extra, self.feed_names))
        vals = {n: _validated(n, feed[n], self._inputs[n])
                for n in self.feed_names}
        exe = self._executor
        with exe._lock:
            fetches, _ = exe._step(self._step, self._holder, vals, 0)
            return exe._convert_fetches(None, fetches, True, False)

    __call__ = run

    def cache_stats(self):
        """The executor's counters (captures, replays)."""
        return self._executor.cache_stats


def load_compiled(dirname, place=None):
    """Load an export_compiled artifact -> a CompiledModel (callable with
    a feed dict -> [ndarray]; feed_names, fetch_names, input_spec).

    place None means CUDAPlace(0), which raises without a card; an
    artifact exported for another device type raises naming both. Feeds
    are validated against the shapes and dtypes recorded at export: a
    missing or unknown name, a wrong shape (the module is fixed-shape,
    batch included) or a dtype cast across kinds raises a ValueError
    naming the input."""
    return CompiledModel(dirname, place)
