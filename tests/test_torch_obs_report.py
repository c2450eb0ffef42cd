"""The port's run-log report and SLO budgets (obs/report.py, obs/slo.py,
copies of the JAX package's) against the JAX modules, on the CPU:

  * a run log that the port's trainer, tier store and publisher wrote
    (train_stream over a TieredVocabTable with a DeltaPublisher, at the
    JAX tests/test_streaming.py net's size): every record valid under
    both packages' validate_record, and the port's `summarize` the same
    text as the JAX one, its `-- streaming --` and `-- tiers --` sections
    included; collect_events, latest_run and percentile_exact equal;
  * validate_record case by case on the malformed records of the JAX
    tests/test_obs.py:357, and more;
  * the SLO budgets of the JAX tests/test_obs.py:553-608 against the
    port's slo and a fresh port Registry: pass, fail and missing typed,
    strict mode, unknown keys, recovery_s and dropped from events;
    KNOWN_BUDGETS equal; each budget's source metric present in the
    port's registry under the JAX name (server_ttft_p99_s, whose
    histogram the port does not record yet, measured as missing); and
    tools/slo_budgets.json graded over the port's registry after the
    stream (the freshness lag measured), equal to the JAX grading of the
    same measurements.
"""
import json
import os

import numpy as np
import pytest

import jax  # noqa: F401  (conftest pins it to the CPU)

from paddle_tpu.obs import metrics as jmetrics
from paddle_tpu.obs import report as jreport
from paddle_tpu.obs import slo as jslo

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import obs as tobs
from paddle_tpu_torch import streaming as tstreaming
from paddle_tpu_torch.obs import metrics as tmetrics
from paddle_tpu_torch.obs import report as treport
from paddle_tpu_torch.obs import slo as tslo

from test_torch_streaming import NET_FIELDS, _net

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUDGETS = os.path.join(REPO, 'tools', 'slo_budgets.json')


class _Sink(object):
    def push_rows(self, deltas):
        return sum(len(v[0]) for v in deltas.values())


def _tiered_run_log(tmp_path):
    """Train the JAX test_streaming net through train_stream over a
    TieredVocabTable (capacity 8: spills and warm restores) with a
    DeltaPublisher and a checkpoint every 4 steps, observability on.
    Returns the run log's path."""
    tobs.enable(str(tmp_path / 'obs'))
    try:
        t = tfluid.Trainer(
            lambda: [_net(tfluid)[3]],
            lambda: tfluid.optimizer.Adam(learning_rate=0.05),
            place=tfluid.CPUPlace(), double_buffer=True,
            checkpoint_config=tfluid.CheckpointConfig(
                checkpoint_dir=str(tmp_path / 'ck'), step_interval=4))
        vt = tstreaming.VocabTable(capacity=8, table='emb_w',
                                   admit_count=1)
        tt = tstreaming.TieredVocabTable(
            vt, tstreaming.HostArena(str(tmp_path / 'tier'), 64))
        pub = tstreaming.DeltaPublisher(_Sink(), interval_steps=2)
        seq = (1, 2, 3, 4, 5, 6, 7, 11, 12, 13, 1, 2, 3, 4, 5, 21, 22, 6, 7)
        batches = [[(np.full((NET_FIELDS, 1), i, 'int64'),
                     np.ones((1,), 'float32'))] for i in seq]
        t.train_stream(lambda: iter(batches), vocabs={'ids': tt},
                       publisher=pub)
        assert tt.spilled >= 1 and tt.restored >= 1 and pub.pushes >= 1
        return tobs.run_log_path()
    finally:
        tobs._reset()


def test_summarize_is_the_jax_text_on_the_ports_run_log(tmp_path):
    path = _tiered_run_log(tmp_path)
    got, got_err = treport.load_events(path)
    want, want_err = jreport.load_events(path)
    assert got_err == want_err == []
    assert got == want and len(got) > 20
    names = {e['name'] for e in got}
    for n in ('trainer.step', 'trainer.input_stage', 'streaming.admit',
              'streaming.evict', 'streaming.delta_push',
              'streaming.tier.spill', 'streaming.tier.restore',
              'streaming.tier.prefetch', 'trainer.checkpoint.save'):
        assert n in names, n
    text = treport.summarize(got)
    assert text == jreport.summarize(want)
    for section in ('-- streaming --', '-- tiers --', 'restored warm',
                    'delta pushes:', 'arena: '):
        assert section in text, section
    d = str(tmp_path / 'obs')
    assert treport.latest_run(d) == jreport.latest_run(d) == path
    assert treport.collect_events(d) == jreport.collect_events(d)
    assert treport.collect_events(d, merge_dir=True) == \
        jreport.collect_events(d, merge_dir=True)


@pytest.mark.parametrize('values,p', [
    ([], 50), ([3.0], 99), ([5.0, 1.0, 4.0, 2.0], 50),
    ([0.1 * i for i in range(37)], 99), ([2.0, 2.0, 7.5], 0)])
def test_percentile_exact_is_the_jax_one(values, p):
    assert treport.percentile_exact(values, p) == \
        jreport.percentile_exact(values, p)


_RECORDS = [
    {'ts': 1.0, 'kind': 'event', 'name': 'ok', 'span': None, 'fields': {}},
    'this is not a dict',
    {'ts': 'late', 'kind': 'event', 'name': 'bad-ts'},
    {'ts': 2.0, 'kind': 'span', 'name': 'no-dur'},
    {'ts': 2.0, 'kind': 'span', 'name': 'dur', 'dur_s': 0.5},
    {'ts': True, 'kind': 'event', 'name': 'bool-ts'},
    {'ts': 1, 'kind': 'event', 'name': ''},
    {'ts': 1, 'kind': 'metric', 'name': 'bad-kind'},
    {'ts': 1, 'kind': 'meta', 'name': 'run_start', 'fields': []},
    {'ts': 1, 'kind': 'span', 'name': 's', 'dur_s': False},
    {'ts': 1, 'kind': 'event', 'name': 'e', 'span': 'x'},
    {'ts': 1, 'kind': 'event', 'name': 'e', 'span': 3},
]


@pytest.mark.parametrize('i', range(len(_RECORDS)))
def test_validate_record_agrees_case_by_case(i):
    assert treport.validate_record(_RECORDS[i]) == \
        jreport.validate_record(_RECORDS[i])


def test_load_events_flags_the_jax_malformed_records(tmp_path):
    """tests/test_obs.py:357's file: three malformed lines, one good."""
    p = tmp_path / 'run-bad.jsonl'
    good = {'ts': 1.0, 'kind': 'event', 'name': 'ok', 'span': None,
            'fields': {}}
    p.write_text(json.dumps(good) + '\n'
                 + 'this is not json\n'
                 + json.dumps({'ts': 'late', 'kind': 'event',
                               'name': 'bad-ts'}) + '\n'
                 + json.dumps({'ts': 2.0, 'kind': 'span',
                               'name': 'no-dur'}) + '\n')
    got = treport.load_events(str(p))
    assert got == jreport.load_events(str(p))
    assert got[0] == [good] and len(got[1]) == 3


# ---------------------------------------------------------------------------
# SLO budgets
# ---------------------------------------------------------------------------

def test_slo_budget_pass_fail_missing_typed():
    reg = tmetrics.Registry()
    h = reg.histogram('serving.stream.ttft.seconds')
    for _ in range(20):
        h.observe(0.010)
    budget = tslo.SloBudget.from_dict(
        {'_comment': 'ignored',
         'budgets': {'ttft_p99_s': 1.0, 'recovery_s': 5.0}})
    res = budget.evaluate(registry=reg)
    assert res.passed
    assert [m.budget for m in res.missing] == ['recovery_s']
    assert any(line.endswith('PASS') for line in res.lines())

    res2 = tslo.SloBudget({'ttft_p99_s': 0.001}).evaluate(registry=reg)
    assert not res2.passed
    v = res2.violations[0]
    assert isinstance(v, tslo.SloViolation)
    assert v.budget == 'ttft_p99_s' and v.measured > v.limit
    assert 'ttft_p99_s' in v.describe()

    strict = tslo.SloBudget({'recovery_s': 5.0})
    assert strict.evaluate(registry=reg).passed
    assert not strict.evaluate(registry=reg, strict_missing=True).passed
    assert isinstance(strict.evaluate(registry=reg).missing[0],
                      tslo.SloMissing)

    future = tslo.SloBudget({'not_yet_a_budget': 1.0}).evaluate(registry=reg)
    assert [m.budget for m in future.missing] == ['not_yet_a_budget']
    with pytest.raises(ValueError, match='JSON object'):
        tslo.SloBudget.from_dict([1])


def test_slo_measures_recovery_and_dropped_from_events():
    reg = tmetrics.Registry()
    ev = [{'name': 'serving.replica.reshard', 'fields': {'heal_s': 2.5}},
          {'name': 'bench.metric',
           'fields': {'metric': 'serve.decode_failover.resume_s',
                      'value': 0.75}},
          {'name': 'serving.stream.first_token',
           'fields': {'ttft_s': 0.02, 'server_ttft_s': 0.01}}]
    m = tslo.measure(registry=reg, events=ev)
    assert m['recovery_s'] == 2.5
    assert m['ttft_p50_s'] == 0.02 and m['server_ttft_p99_s'] == 0.01
    assert 'dropped' not in tslo.measure(registry=reg)
    reg.counter('serving.shed').inc(0)
    assert tslo.measure(registry=reg).get('dropped') == 0
    reg.counter('decode.rejected').inc(2)
    assert tslo.measure(registry=reg)['dropped'] == 2


def _fill(metrics):
    reg = metrics.Registry()
    h = reg.histogram('serving.stream.ttft.seconds')
    for x in (0.004, 0.2, 0.03, 0.5, 0.01):
        h.observe(x)
    d = reg.histogram('decode.step.seconds')
    for x in (0.001, 0.003, 0.002):
        d.observe(x)
    reg.gauge('streaming.freshness_lag_s').set(0.04)
    reg.counter('serving.shed').inc(1)
    reg.counter('serving.rejected').inc(0)
    return reg


def test_slo_grades_like_jax_on_the_same_measurements():
    assert tslo.KNOWN_BUDGETS == jslo.KNOWN_BUDGETS
    got = tslo.measure(registry=_fill(tmetrics))
    assert got == jslo.measure(registry=_fill(jmetrics))
    budget = {'ttft_p50_s': 0.05, 'ttft_p99_s': 0.1, 'dropped': 0,
              'freshness_lag_s': 1.0, 'per_token_p99_s': 0.01}
    tres = tslo.SloBudget(budget).evaluate(registry=_fill(tmetrics))
    jres = jslo.SloBudget(budget).evaluate(registry=_fill(jmetrics))
    assert tres.lines() == jres.lines() and not tres.passed
    assert sorted(v.budget for v in tres.violations) == ['dropped',
                                                         'ttft_p99_s']


def test_slo_budget_sources_are_the_ports_metric_names(tmp_path):
    """Each key's source metric is registered in the port's registry
    under the JAX name once the recording modules are imported; the one
    the port does not record (the cross-host first-token frame) is
    reported missing, not faked. tools/slo_budgets.json graded over the
    registry after a tiered stream: the freshness lag measured."""
    from paddle_tpu_torch.serving import decode, engine, router  # noqa: F401
    from paddle_tpu_torch.streaming import publish  # noqa: F401
    reg = tobs.REGISTRY
    for name in ('serving.stream.ttft.seconds', 'decode.step.seconds',
                 'streaming.freshness_lag_s', 'serving.shed',
                 'serving.rejected', 'decode.shed', 'decode.rejected',
                 'serving.requests', 'decode.requests',
                 'serving.stream.tokens'):
        assert reg.find(name), name
    assert not reg.find('serving.stream.server_ttft.seconds')
    _tiered_run_log(tmp_path)
    # the process's registry: other tests in this worker may have shed
    # or streamed, so only what this stream set is asserted
    res = tslo.SloBudget.from_file(BUDGETS).evaluate()
    ok = {b: m for b, _, m in res.ok}
    assert ok['freshness_lag_s'] == \
        reg.find('streaming.freshness_lag_s')[0].value
    assert 'dropped' in ok or 'dropped' in {v.budget
                                            for v in res.violations}
    assert 'server_ttft_p99_s' in {m.budget for m in res.missing}
    jres = jslo.SloBudget.from_file(BUDGETS).evaluate(
        registry=jmetrics.Registry(), measured=tslo.measure())
    assert jres.lines() == res.lines()
