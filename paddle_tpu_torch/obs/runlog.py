"""Structured JSONL run log: one event per record, append-only, flushed.

Each record is a single JSON object on its own line:

    {"ts": <monotonic seconds, float>,
     "kind": "meta" | "event" | "span",
     "name": "<dotted event name>",
     "span": <enclosing span id or null>,
     "parent": <parent span id, span records only>,
     "dur_s": <wall seconds, span records only>,
     "fields": {...}}

`ts` is time.monotonic() so intervals are immune to wall-clock jumps; the
run_start meta record carries the wall-clock anchor ("time" ISO-8601) for
humans correlating against external logs. Writes are flushed per record so
a crash (or a driver timeout) loses at most the in-flight line, and
tools/obs_report.py can read a log while the run is still going.

stdlib-only (see metrics.py for why).
"""
import json
import os
import threading
import time

from .metrics import REGISTRY

__all__ = ['RunLog', 'new_run_path']

_SEQ_LOCK = threading.Lock()
_SEQ = [0]


def _json_default(o):
    """Fields may carry numpy scalars / device-array leftovers; fall back
    to .item() (exact for numpy scalars) then str(). Never raises — a
    telemetry write must not take down the training step it observes."""
    item = getattr(o, 'item', None)
    if callable(item):
        try:
            return item()
        except Exception:
            pass
    return str(o)


def new_run_path(obs_dir):
    """A collision-free run-log path under obs_dir:
    run-<utc stamp>-p<pid>-<seq>.jsonl (seq disambiguates multiple runs
    started within one second of one process)."""
    with _SEQ_LOCK:
        _SEQ[0] += 1
        seq = _SEQ[0]
    stamp = time.strftime('%Y%m%dT%H%M%S', time.gmtime())
    return os.path.join(obs_dir,
                        'run-%s-p%d-%d.jsonl' % (stamp, os.getpid(), seq))


class RunLog(object):
    """Append-only JSONL writer. The file (and its directory) is created
    on construction; callers create RunLogs lazily so an enabled-but-idle
    process leaves no output file behind.

    RING-BUFFER MODE (`max_events=`): a week-long train_stream or decode
    soak must not grow the log without bound, so once the file exceeds
    max_events records (plus ~10% slack so compaction amortizes) it is
    rewritten in place — atomic tmp + os.replace, reopened for append —
    keeping the run_start meta line and the newest max_events records.
    Eviction is NEVER silent: every dropped record counts on the
    `obs.runlog.dropped` counter and the rewritten file leads with a
    `runlog.dropped` meta record carrying the cumulative total. Memory
    stays O(1) — the ring lives in the file, not in RAM. Do not use on a
    file shared by several live writers (the pinned
    PADDLE_TPU_OBS_RUN_FILE case): compaction would drop their racing
    appends — paddle_tpu_torch.obs leaves pinned files unbounded by default."""

    def __init__(self, path, max_events=None):
        self.path = path
        self.max_events = int(max_events) if max_events else None
        self.dropped = 0
        self._lines = 0
        self._compact_failed = False
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._lock = threading.Lock()
        is_new = not os.path.exists(path) or os.path.getsize(path) == 0
        if not is_new and self.max_events:
            try:
                with open(path, 'rb') as f:
                    self._lines = sum(1 for _ in f)
            except Exception:
                self._lines = 0
        self._f = open(path, 'a')
        if is_new:
            # several processes may share one pinned run file
            # (PADDLE_TPU_OBS_RUN_FILE); only the creator stamps run_start
            self.write({'ts': time.monotonic(), 'kind': 'meta',
                        'name': 'run_start', 'span': None,
                        'fields': {'pid': os.getpid(),
                                   'time': time.strftime(
                                       '%Y-%m-%dT%H:%M:%S%z')}})

    def _compact_locked(self):
        """Rewrite the file keeping run_start + the newest max_events
        records; stale dropped-notices are superseded, not stacked."""
        with open(self.path, 'r') as f:
            lines = f.read().splitlines()
        head = [ln for ln in lines[:2] if '"name":"run_start"' in ln][:1]
        body = [ln for ln in lines if ln not in head
                and '"name":"runlog.dropped"' not in ln]
        keep = body[-self.max_events:]
        newly = len(body) - len(keep)
        if newly <= 0:
            self._lines = len(lines)
            return
        self.dropped += newly
        REGISTRY.counter('obs.runlog.dropped').inc(newly)
        notice = json.dumps(
            {'ts': time.monotonic(), 'kind': 'meta',
             'name': 'runlog.dropped', 'span': None,
             'fields': {'dropped': self.dropped,
                        'max_events': self.max_events}},
            separators=(',', ':'))
        tmp = '%s.tmp%d' % (self.path, os.getpid())
        out = head + [notice] + keep
        with open(tmp, 'w') as f:
            f.write('\n'.join(out) + '\n')
        self._f.close()
        os.replace(tmp, self.path)
        self._f = open(self.path, 'a')
        self._lines = len(out)

    def write(self, record):
        try:
            line = json.dumps(record, separators=(',', ':'),
                              default=_json_default)
        except Exception:
            return  # telemetry must never crash the instrumented code
        with self._lock:
            if self._f is None:
                return
            try:
                self._f.write(line + '\n')
                self._f.flush()
                self._lines += 1
                if (self.max_events and not self._compact_failed
                        and self._lines > self.max_events
                        + max(32, self.max_events // 10)):
                    try:
                        self._compact_locked()
                    except Exception:
                        # unwritable tmp / torn file: stop trying, the
                        # log just stays append-only from here
                        self._compact_failed = True
            except Exception as e:
                # disk full / fd revoked mid-run: the instrumented step
                # must survive. Disable THIS run log and say so once.
                try:
                    self._f.close()
                except Exception:
                    pass
                self._f = None
                import warnings
                warnings.warn(
                    'obs run log %r became unwritable (%s: %s); telemetry '
                    'file output disabled for the rest of this run'
                    % (self.path, type(e).__name__, e), RuntimeWarning)

    def close(self):
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None
