"""Metric layers. Parity: reference layers/metric_op.py and the JAX
package's fluid/layers/metric_op.py:29-49 (auc); accuracy waits with its
top_k rule."""
from ..layer_helper import LayerHelper
from ..initializer import Constant

__all__ = ['auc']


def auc(input, label, curve='ROC', num_thresholds=200, topk=1):
    """Streaming AUC with persistable histogram state (reference
    layers/metric_op.py:auc + operators/auc_op.cc)."""
    helper = LayerHelper("auc", **locals())
    stat_pos = helper.create_global_variable(
        persistable=True, dtype='int64', shape=[num_thresholds],
        name=helper.name + '.stat_pos')
    stat_neg = helper.create_global_variable(
        persistable=True, dtype='int64', shape=[num_thresholds],
        name=helper.name + '.stat_neg')
    for var in [stat_pos, stat_neg]:
        helper.set_variable_initializer(var, Constant(value=0.0))
    auc_out = helper.create_variable_for_type_inference(dtype="float32")
    helper.append_op(
        type="auc",
        inputs={"Predict": [input], "Label": [label],
                "StatPos": [stat_pos], "StatNeg": [stat_neg]},
        outputs={"AUC": [auc_out], "StatPosOut": [stat_pos],
                 "StatNegOut": [stat_neg]},
        attrs={"curve": curve, "num_thresholds": num_thresholds})
    return auc_out
