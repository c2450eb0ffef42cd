"""Deprecated Evaluator shims. Parity: reference python/paddle/fluid/evaluator.py
(the reference deprecates these toward fluid.metrics); the port's own copy
of the JAX package's fluid/evaluator.py."""
import warnings

from . import metrics as _metrics

__all__ = ['ChunkEvaluator', 'EditDistance', 'DetectionMAP']


def _deprecated(name):
    warnings.warn("fluid.evaluator.%s is deprecated; use fluid.metrics.%s"
                  % (name, name), DeprecationWarning)


class ChunkEvaluator(_metrics.ChunkEvaluator):
    def __init__(self, *args, **kwargs):
        _deprecated('ChunkEvaluator')
        super(ChunkEvaluator, self).__init__()


class EditDistance(_metrics.EditDistance):
    def __init__(self, *args, **kwargs):
        _deprecated('EditDistance')
        super(EditDistance, self).__init__()


class DetectionMAP(_metrics.DetectionMAP):
    def __init__(self, *args, **kwargs):
        _deprecated('DetectionMAP')
        super(DetectionMAP, self).__init__()
