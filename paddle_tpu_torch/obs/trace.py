"""Request-scoped distributed tracing: one trace_id per request.

Parity: the JAX package's obs/trace.py, whole. A request that enters at
`Router.submit`/`Router.stream` gets a TraceContext: `trace_id` naming the
request, `span_id` naming the span the next hop should parent under. It
propagates two ways:

  * IN-PROCESS via a contextvar: while a context is active
    (`activate()`), every `obs.span`/`obs.event` picks it up with no
    signature change: span records gain `trace`/`tspan`/`tparent`
    keys in the run log AND a completed-span record in the trace
    buffer below;
  * ACROSS PROCESSES via `headers()` -> `from_headers()`: a plain
    JSON-safe dict a transport carries in its frame header, so the far
    side re-enters the SAME trace before serving.

Span records are buffered per process (bounded; overflow counted on
`obs.trace.dropped`, never silent) and spilled into
`<dir>/spans.p<pid>.json` with an atomic replace. Open spans spill with
`t1: null`: a process that dies mid-request leaves its serve span open in
its last spill, which is how `TraceCollector` flags ORPHANS instead of
dropping them. Timestamps are wall-clock (`time.time()`), not monotonic:
stitching across processes needs one clock domain.

stdlib-only (see metrics.py): the obs package loads without torch.
"""
import collections
import contextvars
import itertools
import json
import os
import threading
import time
import uuid

from .metrics import REGISTRY
from .runlog import _json_default

__all__ = ['TraceContext', 'SpanHandle', 'TraceCollector', 'new_trace',
           'current', 'node', 'activate', 'headers', 'from_headers',
           'begin', 'mark', 'spill', 'set_capacity', 'TRACE_DIR']

# subdirectory of a pod dir that collects per-host span spills
TRACE_DIR = 'traces'
_DEFAULT_CAPACITY = 4096

_ctx = contextvars.ContextVar('paddle_tpu_trace', default=None)
_node = contextvars.ContextVar('paddle_tpu_trace_node', default=None)

_lock = threading.Lock()
_buf = collections.deque()       # completed span/mark records
_open = {}                       # span_id -> still-open span record
_capacity = [_DEFAULT_CAPACITY]
_span_seq = itertools.count(1)
_spill_warned = [False]


class TraceContext(object):
    """(trace_id, span_id) — span_id is the span a child created under
    this context parents to (None at the root)."""

    __slots__ = ('trace_id', 'span_id')

    def __init__(self, trace_id, span_id=None):
        self.trace_id = str(trace_id)
        self.span_id = span_id

    def __repr__(self):
        return 'TraceContext(%r, %r)' % (self.trace_id, self.span_id)


def new_trace():
    """A fresh root context. Nothing becomes current — pair with
    `activate()` (or pass ctx= to `begin()`/`mark()`)."""
    return TraceContext(uuid.uuid4().hex[:16], None)


def current():
    """The active TraceContext of this thread/task, or None."""
    return _ctx.get()


def node():
    """The active node label (host attribution in spilled spans)."""
    return _node.get()


class _Activation(object):
    """Context manager installing `ctx` (and optionally a node label)
    into the contextvars; a None ctx is a clean no-op so call sites
    need no 'was a trace carried?' branches."""

    __slots__ = ('ctx', '_node', '_tok', '_ntok')

    def __init__(self, ctx, node_label):
        self.ctx = ctx
        self._node = node_label
        self._tok = None
        self._ntok = None

    def __enter__(self):
        if self.ctx is not None:
            self._tok = _ctx.set(self.ctx)
            if self._node is not None:
                self._ntok = _node.set(str(self._node))
        return self.ctx

    def __exit__(self, exc_type, exc, tb):
        for var, tok in ((_node, self._ntok), (_ctx, self._tok)):
            if tok is not None:
                try:
                    var.reset(tok)
                except Exception:
                    pass
        self._tok = self._ntok = None
        return False


def activate(ctx, node=None):
    """`with activate(ctx, node='h0'): ...` — make `ctx` current so
    obs.span/obs.event (and nested submits) pick it up. ctx=None is a
    no-op."""
    return _Activation(ctx, node)


def headers(ctx=None):
    """The wire form of `ctx` (default: the current context): a
    JSON-safe dict for an rpc frame header / request meta / control
    command. None when there is no trace to carry."""
    if ctx is None:
        ctx = _ctx.get()
    if ctx is None:
        return None
    return {'trace_id': ctx.trace_id, 'parent_id': ctx.span_id}


def from_headers(d):
    """Re-enter a wire-carried context; None for absent/malformed
    headers (an untraced request stays untraced, never crashes)."""
    if not isinstance(d, dict) or not d.get('trace_id'):
        return None
    return TraceContext(d['trace_id'], d.get('parent_id'))


def _new_span_id():
    # unique across processes within a trace: pid-qualified sequence
    return '%x.%x' % (os.getpid(), next(_span_seq))


def _append_locked(rec):
    _buf.append(rec)
    cap = _capacity[0]
    dropped = 0
    while len(_buf) > cap:
        _buf.popleft()
        dropped += 1
    if dropped:
        REGISTRY.counter('obs.trace.dropped').inc(dropped)


def set_capacity(n):
    """Bound of the in-memory span buffer (oldest evicted, counted on
    obs.trace.dropped)."""
    with _lock:
        _capacity[0] = max(1, int(n))
        while len(_buf) > _capacity[0]:
            _buf.popleft()
            REGISTRY.counter('obs.trace.dropped').inc()


def _clean_fields(fields):
    return dict((k, v) for k, v in fields.items() if v is not None)


class SpanHandle(object):
    """An explicitly-ended span for request lifetimes that cross
    threads (a worker opens the serve span on the rpc reader thread
    and ends it from the engine's done callback). `end()` is
    idempotent on t1 but always merges fields, so a late
    'tokens=' merge and an early 'error=' merge both land."""

    __slots__ = ('_rec', 'ctx')

    def __init__(self, rec):
        self._rec = rec
        self.ctx = TraceContext(rec['trace'], rec['span'])

    def mark(self, name, **fields):
        """A zero-duration milestone under this span (thread-safe:
        carries its own context, no contextvar needed)."""
        return _mark_rec(name, self.ctx, self._rec.get('node'), fields)

    def end(self, **fields):
        with _lock:
            self._rec['fields'].update(_clean_fields(fields))
            if self._rec['t1'] is None:
                self._rec['t1'] = time.time()
                _open.pop(self._rec['span'], None)
                _append_locked(self._rec)
        return self


def begin(name, ctx=None, node=None, **fields):
    """Open a request-lifetime span under `ctx` (default: the current
    context). Returns a SpanHandle, or None when there is no trace to
    attach to — callers guard with `if h is not None`. The span sits
    in the OPEN set until `end()`, so a spill that happens first
    records it with t1=None (the orphan flag's raw material)."""
    if ctx is None:
        ctx = _ctx.get()
    if ctx is None:
        return None
    rec = {'trace': ctx.trace_id, 'span': _new_span_id(),
           'parent': ctx.span_id, 'name': str(name),
           'node': str(node) if node is not None else _node.get(),
           'pid': os.getpid(), 't0': time.time(), 't1': None,
           'fields': _clean_fields(fields)}
    with _lock:
        _open[rec['span']] = rec
    return SpanHandle(rec)


def _mark_rec(name, ctx, node_label, fields):
    t = time.time()
    rec = {'trace': ctx.trace_id, 'span': _new_span_id(),
           'parent': ctx.span_id, 'name': str(name), 'node': node_label,
           'pid': os.getpid(), 't0': t, 't1': t, 'mark': True,
           'fields': _clean_fields(fields)}
    with _lock:
        _append_locked(rec)
    return rec


def mark(name, ctx=None, **fields):
    """Record a point-in-time milestone (e.g. trace.first_token) under
    `ctx` or the current context; None when no trace is active."""
    if ctx is None:
        ctx = _ctx.get()
    if ctx is None:
        return None
    return _mark_rec(name, ctx, _node.get(), fields)


# -- obs.Span integration (called by obs.Span) ------------------------------

def _span_begin(name):
    """Hook for obs.Span.__enter__: when a trace is active, open a
    trace span for it and make it the current parent. Returns the
    (record, contextvar token) pair __exit__ hands back, or None."""
    ctx = _ctx.get()
    if ctx is None:
        return None
    rec = {'trace': ctx.trace_id, 'span': _new_span_id(),
           'parent': ctx.span_id, 'name': str(name),
           'node': _node.get(), 'pid': os.getpid(),
           't0': time.time(), 't1': None, 'fields': {}}
    with _lock:
        _open[rec['span']] = rec
    token = _ctx.set(TraceContext(rec['trace'], rec['span']))
    return (rec, token)


def _span_end(info, fields=None, error=None):
    """Hook for obs.Span.__exit__: complete the trace span and restore
    the parent context. Returns the completed record (its trace ids
    are merged into the run-log span record)."""
    rec, token = info
    try:
        _ctx.reset(token)
    except Exception:
        pass
    if fields:
        rec['fields'].update(_clean_fields(fields))
    if error is not None:
        rec['fields']['error'] = error
    with _lock:
        if rec['t1'] is None:
            rec['t1'] = time.time()
            _open.pop(rec['span'], None)
            _append_locked(rec)
    return rec


def _ids():
    """Additive run-log keys for the current context (obs.event): the
    `span` key stays the process-local integer id — trace identity
    rides separate keys so report.validate_record still holds."""
    ctx = _ctx.get()
    if ctx is None:
        return None
    out = {'trace': ctx.trace_id}
    if ctx.span_id is not None:
        out['tspan'] = ctx.span_id
    return out


def _reset():
    """Tests: drop buffered spans and restore the default capacity."""
    with _lock:
        _buf.clear()
        _open.clear()
        _capacity[0] = _DEFAULT_CAPACITY
    _spill_warned[0] = False


# -- spill + stitch ----------------------------------------------------------

def spill(dir_path):
    """Atomic-replace dump of this process's buffer — completed spans
    AND still-open ones (t1=None) — into
    `dir_path/spans.p<pid>.json`. Idempotent per cadence: the file is
    REPLACED, so it always holds the current bounded window. Returns
    the path, or None when there is nothing to spill or the write
    failed (warned once; telemetry never crashes the serving path)."""
    with _lock:
        recs = [dict(r, fields=dict(r['fields'])) for r in _buf]
        recs += [dict(r, fields=dict(r['fields']))
                 for r in sorted(_open.values(), key=lambda r: r['t0'])]
    if not recs:
        return None
    path = os.path.join(str(dir_path), 'spans.p%d.json' % os.getpid())
    tmp = '%s.tmp%d' % (path, os.getpid())
    try:
        os.makedirs(str(dir_path), exist_ok=True)
        with open(tmp, 'w') as f:
            json.dump({'pid': os.getpid(), 'spans': recs}, f,
                      default=_json_default)
        os.replace(tmp, path)
    except Exception as e:
        if not _spill_warned[0]:
            _spill_warned[0] = True
            import warnings
            warnings.warn('trace spill into %r failed (%s: %s); tracing '
                          'continues in memory only'
                          % (str(dir_path), type(e).__name__, e),
                          RuntimeWarning)
        return None
    return path


# canonical request milestones, in causal order; the timeline's stages
# are the deltas between whichever of them the trace actually has
_MILESTONES = ('admit', 'serve', 'dispatch', 'first_token', 'done')


class TraceCollector(object):
    """Stitch per-host spills from a `<pod_dir>/traces/` directory into
    end-to-end request timelines. Spans whose t1 is still None belong
    to hosts that died (or have not spilled their completion yet):
    they are FLAGGED as orphans in the timeline, never dropped."""

    def __init__(self, traces_dir):
        self.traces_dir = str(traces_dir)

    def load(self):
        """Every span record across every host spill (skips torn or
        half-written files; the writers atomic-replace, so a retry
        sees a whole file)."""
        spans = []
        try:
            names = sorted(os.listdir(self.traces_dir))
        except OSError:
            return spans
        for fname in names:
            if not (fname.startswith('spans.')
                    and fname.endswith('.json')):
                continue
            try:
                with open(os.path.join(self.traces_dir, fname)) as f:
                    d = json.load(f)
            except (OSError, ValueError):
                continue
            for rec in (d.get('spans') or []) \
                    if isinstance(d, dict) else []:
                if isinstance(rec, dict) and rec.get('trace'):
                    spans.append(rec)
        return spans

    def traces(self):
        """{trace_id: [span records sorted by t0]}."""
        out = {}
        for rec in self.load():
            out.setdefault(str(rec['trace']), []).append(rec)
        for recs in out.values():
            recs.sort(key=lambda r: (r.get('t0') or 0.0,
                                     str(r.get('span'))))
        return out

    def timeline(self, trace_id=None):
        """One stitched end-to-end timeline: ordered spans across every
        host, the request milestones that were recorded (router admit
        -> worker serve -> engine dispatch -> first token -> done),
        per-stage durations between consecutive milestones, and the
        orphan spans. trace_id may be omitted when the directory holds
        exactly one trace."""
        traces = self.traces()
        if trace_id is None:
            if len(traces) != 1:
                raise ValueError(
                    '%d traces under %r — pass trace_id (have: %s)'
                    % (len(traces), self.traces_dir,
                       sorted(traces)[:8]))
            trace_id = next(iter(traces))
        spans = traces.get(str(trace_id))
        if not spans:
            raise KeyError('no spans for trace %r under %r'
                           % (trace_id, self.traces_dir))
        orphans = [s for s in spans
                   if s.get('t1') is None and not s.get('mark')]

        def first_t0(name):
            ts = [s['t0'] for s in spans
                  if s.get('name') == name and s.get('t0') is not None]
            return min(ts) if ts else None

        def last_t1(name):
            ts = [s['t1'] for s in spans
                  if s.get('name') == name and s.get('t1') is not None]
            return max(ts) if ts else None

        points = {'admit': first_t0('serving.request'),
                  'serve': first_t0('serving.pod.serve'),
                  'dispatch': first_t0('trace.dispatch'),
                  'first_token': first_t0('trace.first_token'),
                  'done': last_t1('serving.request')}
        milestones = [{'name': n, 't': points[n]} for n in _MILESTONES
                      if points[n] is not None]
        stages = []
        for a, b in zip(milestones, milestones[1:]):
            stages.append({'stage': '%s->%s' % (a['name'], b['name']),
                           'seconds': b['t'] - a['t']})
        nodes = sorted({str(s.get('node') or 'p%s' % s.get('pid'))
                        for s in spans})
        start = milestones[0]['t'] if milestones else spans[0].get('t0')
        return {'trace': str(trace_id), 'start': start, 'spans': spans,
                'orphans': orphans, 'milestones': milestones,
                'stages': stages, 'nodes': nodes}
