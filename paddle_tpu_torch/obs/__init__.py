"""paddle_tpu_torch.obs — the runtime telemetry layer of the port.

The counter / gauge / histogram / span / event surface that the executor
and the serving engine record into (the JAX package's paddle_tpu.obs,
reduced to what this slice uses):

  * a process-wide METRICS REGISTRY (obs.metrics): counters, gauges,
    fixed-bucket histograms, always armed;
  * a STRUCTURED RUN LOG: JSONL, one event per record, written under
    $PADDLE_TPU_OBS_DIR (or obs.enable(dir)), created lazily on the first
    record; when observability is disabled there is no file IO at all.
    The records have the schema tools/obs_report.py reads;
  * a SPAN API: `with obs.span("executor.step"): ...` nests via a
    thread-local stack, records wall time into the registry histogram
    `<name>.seconds`, appends a span record to the run log and, when
    observability is on, brackets the region with
    torch.profiler.record_function so the same names appear in a
    torch.profiler trace;
  * the RUN-LOG REPORT (obs.report: validation and the summary
    tools/obs_report.py prints) and the SLO BUDGETS graded against the
    registry (obs.slo), both copied from the JAX package;
  * REQUEST TRACING (obs.trace): while a trace context is active, a span
    joins it (a completed-span record in the trace buffer, and
    `trace`/`tspan`/`tparent` keys on its run-log record) and becomes the
    parent of what opens inside it; events carry the trace ids too.

stdlib-only at import time: torch is reached through sys.modules, and only
when observability is enabled.
"""
import itertools
import os
import sys
import threading
import time

from . import metrics  # noqa: F401
from . import report  # noqa: F401
from . import runlog as _runlog
from . import slo  # noqa: F401
from . import trace  # noqa: F401
from .metrics import REGISTRY, counter, gauge, histogram  # noqa: F401

__all__ = ['metrics', 'report', 'slo', 'trace', 'REGISTRY', 'counter',
           'gauge', 'histogram', 'enabled', 'obs_dir', 'enable', 'disable',
           'event', 'span', 'span_record', 'run_log_path', 'ENV_DIR']

ENV_DIR = 'PADDLE_TPU_OBS_DIR'

_state = {
    'override': None,      # None = follow env; (True, dir) / (False, None)
    'runlog': None,
    'runlog_dir': None,
    'failed_dir': None,    # dir whose run-log creation failed (warn once)
    'lock': threading.RLock(),
}
_span_ids = itertools.count(1)
_local = threading.local()
# span-name -> registry histogram, so the per-span fast path skips the
# registry's label-normalizing lookup
_span_hists = {}


def obs_dir():
    """The active observability directory, or None when disabled.
    obs.enable()/disable() override the PADDLE_TPU_OBS_DIR environment."""
    ov = _state['override']
    if ov is not None:
        return ov[1] if ov[0] else None
    return os.environ.get(ENV_DIR) or None


def enabled():
    return obs_dir() is not None


def enable(dir_path):
    """Force observability on, writing a fresh run log under dir_path."""
    with _state['lock']:
        _close_runlog_locked()
        _state['override'] = (True, str(dir_path))


def disable():
    """Force observability off regardless of the environment."""
    with _state['lock']:
        _close_runlog_locked()
        _state['override'] = (False, None)


def _reset():
    """Back to environment-driven state with no open run log (tests)."""
    with _state['lock']:
        _close_runlog_locked()
        _state['override'] = None
        _span_hists.clear()
    trace._reset()


def _close_runlog_locked():
    rl = _state['runlog']
    if rl is not None:
        rl.close()
    _state['runlog'] = None
    _state['runlog_dir'] = None
    _state['failed_dir'] = None


def _run_log():
    """The current run's RunLog, created lazily; None when disabled. A
    directory whose run log cannot be created is warned about ONCE and then
    skipped — telemetry must never take down the step it observes."""
    d = obs_dir()
    if d is None:
        return None
    rl = _state['runlog']
    if rl is not None and _state['runlog_dir'] == d:
        return rl
    if _state['failed_dir'] == d:
        return None
    with _state['lock']:
        rl = _state['runlog']
        if rl is None or _state['runlog_dir'] != d:
            _close_runlog_locked()
            try:
                rl = _runlog.RunLog(_runlog.new_run_path(d))
            except OSError as e:
                _state['failed_dir'] = d
                import warnings
                warnings.warn(
                    'obs run log unavailable under %r (%s: %s); telemetry '
                    'file output disabled until the directory changes'
                    % (d, type(e).__name__, e), RuntimeWarning)
                return None
            _state['runlog'] = rl
            _state['runlog_dir'] = d
    return rl


def run_log_path():
    """Path of the current run's JSONL file (None when disabled or when
    nothing has been recorded yet)."""
    rl = _state['runlog']
    return rl.path if rl is not None and _state['runlog_dir'] == obs_dir() \
        else None


def _span_stack():
    st = getattr(_local, 'stack', None)
    if st is None:
        st = _local.stack = []
    return st


def current_span_id():
    st = getattr(_local, 'stack', None)
    return st[-1].id if st else None


def event(name, **fields):
    """Record a one-shot event (no-op when disabled). Returns the record
    dict when written, else None."""
    rl = _run_log()
    if rl is None:
        return None
    rec = {'ts': time.monotonic(), 'kind': 'event', 'name': name,
           'span': current_span_id(), 'fields': fields}
    tids = trace._ids()
    if tids:
        rec.update(tids)
    rl.write(rec)
    return rec


class Span(object):
    """Context manager created by obs.span(). After __exit__, `.seconds`
    holds the wall time. `.fields` may be mutated inside the span — the
    run-log record is emitted at exit. `step_num` (a training step's
    ordinal) goes into the record's fields."""
    __slots__ = ('name', 'fields', 'step_num', 'id', 'parent', 't0',
                 'seconds', '_trace', '_tinfo')

    def __init__(self, name, step_num=None, **fields):
        self.name = name
        self.fields = fields
        self.step_num = step_num
        self.id = None
        self.parent = None
        self.t0 = None
        self.seconds = None
        self._trace = None
        self._tinfo = None

    def __enter__(self):
        st = _span_stack()
        self.parent = st[-1].id if st else None
        self.id = next(_span_ids)
        st.append(self)
        # under an active request trace this span joins it and parents
        # whatever opens inside; a no-op otherwise
        self._tinfo = trace._span_begin(self.name)
        if enabled():
            # forward to the profiler only through an already-imported
            # torch: the disabled-mode contract is "no framework import"
            torch = sys.modules.get('torch')
            if torch is not None:
                self._trace = torch.profiler.record_function(self.name)
                self._trace.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.seconds = time.perf_counter() - self.t0
        if self._trace is not None:
            self._trace.__exit__(exc_type, exc, tb)
            self._trace = None
        st = _span_stack()
        if st and st[-1] is self:
            st.pop()
        elif self in st:   # mis-nested exit; stay sane
            st.remove(self)
        _span_hist(self.name).observe(self.seconds)
        err = '%s: %s' % (exc_type.__name__, exc) if exc_type is not None \
            else None
        tids = None
        if self._tinfo is not None:
            trec = trace._span_end(self._tinfo, fields=dict(self.fields),
                                   error=err)
            self._tinfo = None
            tids = {'trace': trec['trace'], 'tspan': trec['span']}
            if trec.get('parent') is not None:
                tids['tparent'] = trec['parent']
        rl = _run_log()
        if rl is not None:
            fields = dict(self.fields)
            if err is not None:
                fields['error'] = err
            if self.step_num is not None:
                fields.setdefault('step_num', self.step_num)
            rec = {'ts': time.monotonic(), 'kind': 'span',
                   'name': self.name, 'span': self.id,
                   'parent': self.parent, 'dur_s': self.seconds,
                   'fields': fields}
            if tids:
                rec.update(tids)
            rl.write(rec)
        return False


def span(name, step_num=None, **fields):
    """Open a nested wall-time span. Always records `<name>.seconds` into
    the registry histogram; when observability is enabled it also appends
    a span record to the run log (with `step_num` among its fields when
    given)."""
    return Span(name, step_num=step_num, **fields)


def _span_hist(name):
    h = _span_hists.get(name)
    if h is None:
        h = REGISTRY.histogram(name + '.seconds')
        _span_hists[name] = h
    return h


def span_record(name, seconds, **fields):
    """Record a span POST-HOC (the JAX :301): the caller timed the region
    itself, e.g. the Trainer's `trainer.input_stage`, the time its loop
    waited for the next staged batch. Feeds the same registry histogram
    and run-log span schema as span(); no profiler range (the region is
    already over). Returns the record dict when written to the run log,
    else None."""
    seconds = float(seconds)
    _span_hist(name).observe(seconds)
    rl = _run_log()
    if rl is None:
        return None
    rec = {'ts': time.monotonic(), 'kind': 'span', 'name': name,
           'span': next(_span_ids), 'parent': current_span_id(),
           'dur_s': seconds, 'fields': dict(fields)}
    tids = trace._ids()
    if tids:
        rec.update(tids)
    rl.write(rec)
    return rec
