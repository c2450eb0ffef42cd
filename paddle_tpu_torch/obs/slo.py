"""Declarative SLO budgets graded against live telemetry.

A budget file is plain JSON mapping budget keys to numeric ceilings
(docs/observability.md#slo-budgets has the schema):

    {"_comment": "ignored",
     "budgets": {"ttft_p50_s": 2.5, "ttft_p99_s": 6.0, "dropped": 0}}

`SloBudget.evaluate()` measures each key from the metrics registry
(histogram percentiles, gauge values, counter totals) and, when a
run-log event list is supplied, from events too (recovery_s comes from
heal drills, which only events record). Every key resolves to exactly
one of three TYPED outcomes:

  * ok        — measured <= limit
  * violation — SloViolation(budget, limit, measured); result.passed
                is False and renderers name the violated percentile
  * missing   — SloMissing(budget, limit): the budget was declared but
                nothing measured it (e.g. recovery_s in a run with no
                heal drill). Reported loudly, but NOT a failure —
                otherwise every budget file would need a per-workload
                variant; pass `strict_missing=True` to make it one.

Parity: the JAX package's obs/slo.py, copied as it is. Each key is
measured from the port's registry under the same metric names; a key whose
source the port does not record yet (server_ttft_p99_s: the cross-host
replicas' first-token frame) evaluates as missing, as it does in a JAX run
without that path. stdlib-only (see metrics.py for why).
"""
import json

from .metrics import REGISTRY, Counter, Gauge, Histogram
from .report import percentile_exact

__all__ = ['SloBudget', 'SloResult', 'SloViolation', 'SloMissing',
           'measure', 'KNOWN_BUDGETS']

# budget key -> how it is measured (the docs table mirrors this)
KNOWN_BUDGETS = {
    'ttft_p50_s': 'p50 of serving.stream.ttft.seconds (client-side)',
    'ttft_p99_s': 'p99 of serving.stream.ttft.seconds (client-side)',
    'server_ttft_p99_s':
        'p99 of serving.stream.server_ttft.seconds (dispatch->token 1)',
    'per_token_p99_s': 'p99 of decode.step.seconds',
    'recovery_s': 'slowest heal: serving.replica.reshard heal_s / '
                  'bench.metric *recovery_s|*resume_s events',
    'freshness_lag_s': 'streaming.freshness_lag_s gauge',
    'dropped': 'serving/decode shed+rejected totals plus stream '
               'failovers that never resumed',
}


def _hist_pct(reg, name, p):
    for inst in reg.find(name):
        if isinstance(inst, Histogram) and inst.count:
            return inst.percentile(p)
    return None


def _gauge(reg, name):
    for inst in reg.find(name):
        if isinstance(inst, Gauge) and inst.value is not None:
            return inst.value
    return None


def _counters_seen(reg, names):
    return any(isinstance(i, Counter)
               for n in names for i in reg.find(n))


def measure(registry=None, events=None):
    """Best-effort {budget_key: measured value}. Keys nothing measured
    are ABSENT (evaluate() types them as missing). Events, when given,
    fill what the registry cannot (recovery_s) and back-fill TTFT
    percentiles for offline runs whose registry is empty."""
    reg = registry if registry is not None else REGISTRY
    out = {}
    for key, name, p in (('ttft_p50_s', 'serving.stream.ttft.seconds', 50),
                         ('ttft_p99_s', 'serving.stream.ttft.seconds', 99),
                         ('server_ttft_p99_s',
                          'serving.stream.server_ttft.seconds', 99),
                         ('per_token_p99_s', 'decode.step.seconds', 99)):
        v = _hist_pct(reg, name, p)
        if v is not None:
            out[key] = v
    v = _gauge(reg, 'streaming.freshness_lag_s')
    if v is not None:
        out['freshness_lag_s'] = v
    # dropped is only meaningful once some admission/stream path ran;
    # an empty registry must report it MISSING, not a vacuous 0
    drop_names = ('serving.shed', 'serving.rejected', 'decode.shed',
                  'decode.rejected', 'serving.stream.failovers',
                  'serving.stream.resumes', 'serving.stream.tokens',
                  'serving.requests', 'decode.requests')
    if _counters_seen(reg, drop_names):
        unresumed = max(0.0, reg.total('serving.stream.failovers')
                        - reg.total('serving.stream.resumes'))
        out['dropped'] = (reg.total('serving.shed')
                          + reg.total('serving.rejected')
                          + reg.total('decode.shed')
                          + reg.total('decode.rejected') + unresumed)
    if events:
        recov = []
        ttft, sttft = [], []
        for ev in events:
            name = ev.get('name')
            fields = ev.get('fields') or {}
            if name == 'serving.replica.reshard' and \
                    fields.get('heal_s') is not None:
                recov.append(float(fields['heal_s']))
            elif name == 'bench.metric' and \
                    (str(fields.get('metric', '')).endswith('recovery_s')
                     or str(fields.get('metric', '')).endswith('resume_s')) \
                    and fields.get('value') is not None:
                # a SIGKILL drill's stream-resume time IS its recovery
                recov.append(float(fields['value']))
            elif name == 'serving.stream.first_token':
                if fields.get('ttft_s') is not None:
                    ttft.append(float(fields['ttft_s']))
                if fields.get('server_ttft_s') is not None:
                    sttft.append(float(fields['server_ttft_s']))
        if recov:
            out['recovery_s'] = max(recov)
        if ttft:
            out.setdefault('ttft_p50_s', percentile_exact(ttft, 50))
            out.setdefault('ttft_p99_s', percentile_exact(ttft, 99))
        if sttft:
            out.setdefault('server_ttft_p99_s',
                           percentile_exact(sttft, 99))
    return out


class SloViolation(object):
    """measured > limit for one budget key."""
    __slots__ = ('budget', 'limit', 'measured')

    def __init__(self, budget, limit, measured):
        self.budget = str(budget)
        self.limit = float(limit)
        self.measured = float(measured)

    def describe(self):
        return ('SLO VIOLATION: %s measured %.6g exceeds budget %.6g'
                % (self.budget, self.measured, self.limit))

    def __repr__(self):
        return 'SloViolation(%s: %.6g > %.6g)' % (
            self.budget, self.measured, self.limit)


class SloMissing(object):
    """A declared budget nothing in this run measured."""
    __slots__ = ('budget', 'limit')

    def __init__(self, budget, limit):
        self.budget = str(budget)
        self.limit = float(limit)

    def describe(self):
        return ('SLO MISSING: %s has budget %.6g but no measurement '
                'in this run' % (self.budget, self.limit))

    def __repr__(self):
        return 'SloMissing(%s: budget %.6g)' % (self.budget, self.limit)


class SloResult(object):
    """Outcome of one evaluation: `ok` [(budget, limit, measured)],
    `violations` [SloViolation], `missing` [SloMissing]."""

    def __init__(self, ok, violations, missing, strict_missing=False):
        self.ok = list(ok)
        self.violations = list(violations)
        self.missing = list(missing)
        self.strict_missing = bool(strict_missing)

    @property
    def passed(self):
        if self.violations:
            return False
        if self.strict_missing and self.missing:
            return False
        return True

    def lines(self):
        out = []
        for budget, limit, measured in self.ok:
            out.append('SLO OK: %s = %.6g (budget %.6g)'
                       % (budget, measured, limit))
        for v in self.violations:
            out.append(v.describe())
        for m in self.missing:
            out.append(m.describe())
        out.append('SLO: %d ok, %d violated, %d missing -> %s'
                   % (len(self.ok), len(self.violations),
                      len(self.missing),
                      'PASS' if self.passed else 'FAIL'))
        return out

    def __repr__(self):
        return 'SloResult(passed=%s, ok=%d, violations=%r, missing=%r)' \
            % (self.passed, len(self.ok), self.violations, self.missing)


class SloBudget(object):
    """The declared ceilings. Unknown keys are legal (they evaluate as
    missing — a budget written for a future metric fails loudly as
    MISSING instead of silently passing); '_'-prefixed keys are
    comments."""

    def __init__(self, budgets):
        self.budgets = {}
        for k, v in dict(budgets).items():
            if str(k).startswith('_'):
                continue
            self.budgets[str(k)] = float(v)

    @classmethod
    def from_dict(cls, d):
        if not isinstance(d, dict):
            raise ValueError('SLO budget must be a JSON object, got %s'
                             % type(d).__name__)
        inner = d.get('budgets')
        return cls(inner if isinstance(inner, dict) else d)

    @classmethod
    def from_file(cls, path):
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def evaluate(self, registry=None, events=None, measured=None,
                 strict_missing=False):
        """Grade every declared budget. `measured` (a dict) overrides /
        extends what measure() finds — tests and bench reps inject
        windowed percentiles this way."""
        vals = measure(registry=registry, events=events)
        if measured:
            vals.update(measured)
        ok, violations, missing = [], [], []
        for budget in sorted(self.budgets):
            limit = self.budgets[budget]
            m = vals.get(budget)
            if m is None:
                missing.append(SloMissing(budget, limit))
            elif float(m) > limit:
                violations.append(SloViolation(budget, limit, m))
            else:
                ok.append((budget, limit, float(m)))
        return SloResult(ok, violations, missing,
                         strict_missing=strict_missing)
