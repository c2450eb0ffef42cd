"""Metric layers. Parity: reference layers/metric_op.py and the JAX
package's fluid/layers/metric_op.py (accuracy :8, auc :29)."""
from ..layer_helper import LayerHelper
from ..initializer import Constant

__all__ = ['accuracy', 'auc']


def accuracy(input, label, k=1, correct=None, total=None):
    """reference layers/metric_op.py:accuracy — top_k, then the accuracy
    op: the share of rows whose label is among the k largest."""
    helper = LayerHelper("accuracy", **locals())
    topk_out = helper.create_variable_for_type_inference(dtype=input.dtype)
    topk_indices = helper.create_variable_for_type_inference(dtype="int64")
    helper.append_op(type="top_k", inputs={"X": [input]},
                     outputs={"Out": [topk_out], "Indices": [topk_indices]},
                     attrs={"k": k})
    acc_out = helper.create_variable_for_type_inference(dtype="float32")
    if correct is None:
        correct = helper.create_variable_for_type_inference(dtype="int32")
    if total is None:
        total = helper.create_variable_for_type_inference(dtype="int32")
    helper.append_op(type="accuracy",
                     inputs={"Out": [topk_out], "Indices": [topk_indices],
                             "Label": [label]},
                     outputs={"Accuracy": [acc_out], "Correct": [correct],
                              "Total": [total]})
    return acc_out


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
