"""The port's host-side accumulators (fluid/metrics.py, average.py,
evaluator.py) against the JAX package's on the same numpy inputs: every
metrics class, WeightedAverage and the deprecated evaluator shims give the
same values (to the last bit: both are the same numpy arithmetic), the
same config and the same errors."""
import warnings

import numpy as np
import pytest

import jax  # noqa: F401  (conftest pins it to the CPU)

from paddle_tpu.fluid import average as javerage
from paddle_tpu.fluid import evaluator as jevaluator
from paddle_tpu.fluid import metrics as jmetrics

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import average as taverage
from paddle_tpu_torch.fluid import evaluator as tevaluator
from paddle_tpu_torch.fluid import metrics as tmetrics


def _same(a, b):
    """Equal values, nested tuples and lists included."""
    if isinstance(a, (tuple, list)):
        assert isinstance(b, (tuple, list)) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _both(cls, *args, **kw):
    return (getattr(jmetrics, cls)(*args, **kw),
            getattr(tmetrics, cls)(*args, **kw))


def _binary_batches(seed, n_batches=3, rows=17):
    r = np.random.RandomState(seed)
    return [(r.rand(rows, 1).astype('float32'),
             r.randint(0, 2, size=(rows, 1)).astype('int64'))
            for _ in range(n_batches)]


def test_the_port_exports_the_jax_metrics():
    assert tmetrics.__all__ == jmetrics.__all__
    assert taverage.__all__ == javerage.__all__
    assert tevaluator.__all__ == jevaluator.__all__
    assert tfluid.metrics is tmetrics and tfluid.average is taverage
    assert tfluid.evaluator is tevaluator


@pytest.mark.parametrize('name', ['Precision', 'Recall'])
def test_precision_and_recall_stream_like_jax(name):
    j, t = _both(name)
    for preds, labels in _binary_batches(0):
        j.update(preds, labels)
        t.update(preds, labels)
        _same(j.eval(), t.eval())
    assert j.get_config() == t.get_config()
    j.reset()
    t.reset()
    assert j.get_config() == t.get_config()


def test_accuracy_weights_like_jax_and_raises_when_empty():
    j, t = _both('Accuracy', name='acc')
    for v, w in ((0.5, 10), (1.0, 30), (0.25, 7)):
        j.update(value=v, weight=w)
        t.update(value=v, weight=w)
    _same(j.eval(), t.eval())
    j.reset()
    t.reset()
    with pytest.raises(ValueError) as je:
        j.eval()
    with pytest.raises(ValueError) as te:
        t.eval()
    assert str(je.value) == str(te.value)


def test_chunk_evaluator_like_jax():
    j, t = _both('ChunkEvaluator')
    for counts in ((10, 8, 4), (2, 4, 2), (0, 3, 0)):
        j.update(*counts)
        t.update(*counts)
        _same(j.eval(), t.eval())


def test_edit_distance_like_jax():
    j, t = _both('EditDistance')
    r = np.random.RandomState(1)
    for _ in range(3):
        d = r.randint(0, 4, size=5).astype('float32')
        j.update(d, seq_num=5)
        t.update(d, seq_num=5)
        _same(j.eval(), t.eval())


def test_detection_map_like_jax():
    j, t = _both('DetectionMAP')
    for v, w in ((np.array([0.7]), 1), (np.array([0.9]), 2)):
        j.update(v, weight=w)
        t.update(v, weight=w)
    _same(j.eval(), t.eval())


@pytest.mark.parametrize('curve', ['ROC', 'PR'])
def test_auc_like_jax(curve):
    j, t = _both('Auc', curve=curve, num_thresholds=50)
    r = np.random.RandomState(2)
    for _ in range(3):
        labels = r.randint(0, 2, size=200)
        preds = np.clip(labels * 0.3 + r.rand(200) * 0.7, 0, 1)
        preds2 = np.stack([1 - preds, preds], axis=1)
        j.update(preds2, labels)
        t.update(preds2, labels)
        _same(j.eval(), t.eval())


def test_composite_metric_like_jax():
    j, t = _both('CompositeMetric')
    for jm, tm in (_both('Precision'), _both('Recall')):
        j.add_metric(jm)
        t.add_metric(tm)
    for preds, labels in _binary_batches(3):
        j.update(preds, labels)
        t.update(preds, labels)
    _same(j.eval(), t.eval())
    with pytest.raises(ValueError):
        t.add_metric('not a metric')


def test_weighted_average_like_jax():
    j, t = javerage.WeightedAverage(), taverage.WeightedAverage()
    r = np.random.RandomState(4)
    for _ in range(4):
        v = r.rand(1).astype('float32')
        w = int(r.randint(1, 9))
        j.add(value=v, weight=w)
        t.add(value=v, weight=w)
    _same(j.eval(), t.eval())
    j.reset()
    t.reset()
    with pytest.raises(ValueError):
        t.eval()
    with pytest.raises(ValueError):
        t.add(value='x', weight=1)


@pytest.mark.parametrize('name', ['ChunkEvaluator', 'EditDistance',
                                  'DetectionMAP'])
def test_evaluator_shims_warn_and_count_like_jax(name):
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter('always')
        j = getattr(jevaluator, name)()
        t = getattr(tevaluator, name)()
    msgs = [str(w.message) for w in rec
            if issubclass(w.category, DeprecationWarning)]
    assert len(msgs) == 2 and msgs[0] == msgs[1]
    assert isinstance(t, getattr(tmetrics, name))
    assert j.get_config() == t.get_config()
