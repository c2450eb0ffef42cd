"""Process-wide metrics registry: counters, gauges, fixed-bucket histograms.

Prometheus-shaped, host-side, stdlib-only. Instruments are identified by
(name, labels) — labels are how one logical series fans out per call site
(`retry.attempts{site=...}`) or per executor (`executor.cache.hits{exe=...}`)
while reports aggregate across them by name. Everything is thread-safe and
cheap enough to stay armed unconditionally: an increment is one lock plus
one add, so the registry keeps counting even when the run-log side of the
observability layer (PADDLE_TPU_OBS_DIR) is disabled. File IO and trace
forwarding — the costly parts — live in paddle_tpu_torch.obs and are gated
there.

This module imports nothing outside the stdlib: the disabled-mode contract
of the obs layer is "no file, no framework import".
"""
import bisect
import re
import threading

__all__ = ['Counter', 'Gauge', 'Histogram', 'Registry', 'REGISTRY',
           'counter', 'gauge', 'histogram', 'render_prom',
           'DEFAULT_TIME_BUCKETS']

# Exponential seconds buckets spanning sub-ms op dispatch to multi-minute
# compiles. The +Inf overflow bucket is implicit (the last counts slot).
DEFAULT_TIME_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0)


class _Instrument(object):
    kind = None

    def __init__(self, name, labels=()):
        self.name = name
        self.labels = dict(labels)
        # reentrant: an instrument update may allocate, allocation may
        # trigger GC, and a destructor (executor.FetchHandle.__del__)
        # may re-enter instrument code on the SAME thread — a plain Lock
        # would self-deadlock there
        self._lock = threading.RLock()

    def _base_snapshot(self):
        return {'kind': self.kind, 'name': self.name,
                'labels': dict(self.labels)}


class Counter(_Instrument):
    """Monotonically increasing count (or sum — inc() takes a float)."""
    kind = 'counter'

    def __init__(self, name, labels=()):
        super(Counter, self).__init__(name, labels)
        self._value = 0.0

    def inc(self, n=1):
        if n < 0:
            raise ValueError('counters only go up; got inc(%r)' % (n,))
        with self._lock:
            self._value += n

    @property
    def value(self):
        return self._value

    def snapshot(self):
        s = self._base_snapshot()
        s['value'] = self._value
        return s


class Gauge(_Instrument):
    """Last-written value (None until first set)."""
    kind = 'gauge'

    def __init__(self, name, labels=()):
        super(Gauge, self).__init__(name, labels)
        self._value = None

    def set(self, v):
        with self._lock:
            self._value = float(v)

    @property
    def value(self):
        return self._value

    def snapshot(self):
        s = self._base_snapshot()
        s['value'] = self._value
        return s


class Histogram(_Instrument):
    """Fixed-bucket histogram with percentile estimation.

    Buckets are upper bounds; observations above the last bound land in an
    implicit +Inf bucket. Exact min/max/sum/count are tracked alongside, so
    percentile() can clamp its bucket interpolation to values that were
    actually seen (a p95 above the observed max would be a lie)."""
    kind = 'histogram'

    def __init__(self, name, labels=(), buckets=DEFAULT_TIME_BUCKETS):
        super(Histogram, self).__init__(name, labels)
        self.bounds = tuple(sorted(float(b) for b in buckets))
        if not self.bounds:
            raise ValueError('histogram needs at least one bucket bound')
        self._counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = None
        self.max = None

    def observe(self, v):
        v = float(v)
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self._counts[i] += 1
            self.count += 1
            self.sum += v
            if self.min is None or v < self.min:
                self.min = v
            if self.max is None or v > self.max:
                self.max = v

    def percentile(self, p):
        """Estimated p-th percentile (0..100) by linear interpolation
        inside the bucket holding the target rank; None when empty."""
        if not 0 <= p <= 100:
            raise ValueError('percentile must be in [0, 100], got %r' % p)
        with self._lock:
            if self.count == 0:
                return None
            target = max(1, int(round(p / 100.0 * self.count)))
            cum = 0
            for i, c in enumerate(self._counts):
                if c == 0:
                    cum += c
                    continue
                if cum + c >= target:
                    lo = self.bounds[i - 1] if i > 0 else \
                        (self.min if self.min is not None else 0.0)
                    hi = self.bounds[i] if i < len(self.bounds) else self.max
                    frac = (target - cum) / float(c)
                    est = lo + (hi - lo) * frac
                    if self.min is not None:
                        est = max(est, self.min)
                    if self.max is not None:
                        est = min(est, self.max)
                    return est
                cum += c
            return self.max

    @property
    def mean(self):
        return self.sum / self.count if self.count else None

    def percentile_window(self, before, after, p):
        """Estimated p-th percentile over ONLY the observations recorded
        between two snapshot()s — a windowed view of this cumulative
        histogram (serve_bench isolates one benchmark rep's TTFT this
        way). None when the window is empty. Per-window min/max are not
        tracked, so a rank landing in the overflow (+Inf) bucket reports
        the last finite bound — a conservative floor — rather than
        interpolating toward a lifetime max that may belong to an
        observation OUTSIDE the window."""
        if not 0 <= p <= 100:
            raise ValueError('percentile must be in [0, 100], got %r' % p)
        counts = [a[1] - b[1] for b, a in zip(before['buckets'],
                                              after['buckets'])]
        n = sum(counts)
        if n <= 0:
            return None
        target = max(1, int(round(p / 100.0 * n)))
        cum = 0
        for i, c in enumerate(counts):
            if c > 0 and cum + c >= target:
                lo = self.bounds[i - 1] if i > 0 else 0.0
                if i >= len(self.bounds):      # overflow bucket
                    return self.bounds[-1]
                hi = self.bounds[i]
                return lo + (hi - lo) * ((target - cum) / float(c))
            cum += c
        return self.bounds[-1]

    def snapshot(self):
        with self._lock:
            s = self._base_snapshot()
            s.update(count=self.count, sum=self.sum, min=self.min,
                     max=self.max,
                     buckets=[[b, c] for b, c in
                              zip(self.bounds + ('+Inf',), self._counts)])
        s['p50'] = self.percentile(50)
        s['p95'] = self.percentile(95)
        return s


class Registry(object):
    """Name+labels -> instrument store. Getter calls are idempotent: the
    same (name, labels) always returns the SAME instrument, so call sites
    can re-resolve per call instead of caching handles."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments = {}

    def _get(self, cls, name, labels, **kw):
        key = (name, tuple(sorted((str(k), str(v))
                                  for k, v in labels.items())))
        with self._lock:
            inst = self._instruments.get(key)
            if inst is None:
                inst = cls(name, key[1], **kw)
                self._instruments[key] = inst
            elif not isinstance(inst, cls):
                raise TypeError(
                    'metric %r is already registered as a %s, not a %s'
                    % (name, inst.kind, cls.kind))
        return inst

    def counter(self, name, **labels):
        return self._get(Counter, name, labels)

    def gauge(self, name, **labels):
        return self._get(Gauge, name, labels)

    def histogram(self, name, buckets=None, **labels):
        kw = {} if buckets is None else {'buckets': buckets}
        return self._get(Histogram, name, labels, **kw)

    def total(self, name):
        """Sum of counter values across every label set of `name`
        (0.0 when the name was never registered)."""
        with self._lock:
            insts = [i for (n, _), i in self._instruments.items()
                     if n == name and isinstance(i, Counter)]
        return sum(i.value for i in insts)

    def find(self, name):
        """Every instrument registered under `name`, any labels, in
        stable label order ([] when never registered) — how the SLO
        evaluator reaches a histogram's percentile() (snapshots only
        pre-compute p50/p95)."""
        with self._lock:
            return [inst for (n, _), inst in sorted(self._instruments
                                                    .items()) if n == name]

    def snapshot(self):
        """Point-in-time list of every instrument's snapshot dict, sorted
        by (name, labels) for stable diffing."""
        with self._lock:
            insts = sorted(self._instruments.items())
        return [inst.snapshot() for _, inst in insts]

    def reset(self):
        """Drop every instrument (tests only — live handles held by call
        sites keep counting into detached objects)."""
        with self._lock:
            self._instruments.clear()


REGISTRY = Registry()


def counter(name, **labels):
    return REGISTRY.counter(name, **labels)


def gauge(name, **labels):
    return REGISTRY.gauge(name, **labels)


def histogram(name, buckets=None, **labels):
    return REGISTRY.histogram(name, buckets=buckets, **labels)


def _prom_name(name):
    n = re.sub(r'[^a-zA-Z0-9_:]', '_', str(name))
    if not n or not re.match(r'[a-zA-Z_:]', n[0]):
        n = '_' + n
    return n


def _prom_esc(v):
    return str(v).replace('\\', '\\\\').replace('"', '\\"') \
                 .replace('\n', '\\n')


def _prom_labels(labels, extra=()):
    items = sorted(labels.items()) + list(extra)
    if not items:
        return ''
    return '{%s}' % ','.join('%s="%s"' % (_prom_name(k), _prom_esc(v))
                             for k, v in items)


def _prom_num(v):
    return repr(float(v))


def render_prom(registry=None):
    """The whole registry in Prometheus text exposition format (v0.0.4):
    counters as `<name>_total`, gauges as-is (unset gauges skipped),
    histograms as CUMULATIVE `_bucket{le=...}` series plus `_sum` and
    `_count` — our per-bucket counts are accumulated here because that
    is what the wire format specifies. Dotted metric names are
    sanitized (`.` -> `_`); one HELP/TYPE header per metric name. The
    pod serves this on the rpc `metrics` frame and drops it into
    `metrics.h<host>.prom` files on the stats cadence, so a scrape
    needs no run-log parsing."""
    reg = registry if registry is not None else REGISTRY
    lines = []
    headed = set()

    def _head(mname, mtype):
        if mname not in headed:
            headed.add(mname)
            lines.append('# HELP %s paddle_tpu_torch metric' % mname)
            lines.append('# TYPE %s %s' % (mname, mtype))

    for s in reg.snapshot():
        base = _prom_name(s['name'])
        kind = s['kind']
        if kind == 'counter':
            mname = base + '_total'
            _head(mname, 'counter')
            lines.append('%s%s %s' % (mname, _prom_labels(s['labels']),
                                      _prom_num(s['value'])))
        elif kind == 'gauge':
            if s['value'] is None:
                continue
            _head(base, 'gauge')
            lines.append('%s%s %s' % (base, _prom_labels(s['labels']),
                                      _prom_num(s['value'])))
        elif kind == 'histogram':
            _head(base, 'histogram')
            cum = 0
            for bound, c in s['buckets']:
                cum += c
                le = '+Inf' if bound == '+Inf' else _prom_num(bound)
                lines.append('%s_bucket%s %d'
                             % (base, _prom_labels(s['labels'],
                                                   [('le', le)]), cum))
            lines.append('%s_sum%s %s' % (base, _prom_labels(s['labels']),
                                          _prom_num(s['sum'])))
            lines.append('%s_count%s %d' % (base,
                                            _prom_labels(s['labels']),
                                            s['count']))
    return '\n'.join(lines) + '\n' if lines else ''
