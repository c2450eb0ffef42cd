"""Host-side metric accumulators. Parity: reference
python/paddle/fluid/metrics.py; the port's own copy of the JAX package's
fluid/metrics.py (numpy only: the values come to the host as fetches)."""
import copy

import numpy as np

__all__ = ['MetricBase', 'CompositeMetric', 'Precision', 'Recall', 'Accuracy',
           'ChunkEvaluator', 'EditDistance', 'DetectionMAP', 'Auc']


def _is_numpy_(var):
    return isinstance(var, (np.ndarray, np.generic))


class MetricBase(object):
    def __init__(self, name=None):
        self._name = str(name) if name is not None else self.__class__.__name__

    def __str__(self):
        return self._name

    def reset(self):
        states = {
            attr: value
            for attr, value in self.__dict__.items()
            if not attr.startswith("_")
        }
        for attr, value in states.items():
            if isinstance(value, int):
                setattr(self, attr, 0)
            elif isinstance(value, float):
                setattr(self, attr, .0)
            elif isinstance(value, (np.ndarray, np.generic)):
                setattr(self, attr, np.zeros_like(value))
            else:
                setattr(self, attr, None)

    def get_config(self):
        states = {
            attr: value
            for attr, value in self.__dict__.items()
            if not attr.startswith("_")
        }
        config = {}
        config.update({"name": self._name, "states": copy.deepcopy(states)})
        return config

    def update(self, preds, labels):
        raise NotImplementedError()

    def eval(self):
        raise NotImplementedError()


class CompositeMetric(MetricBase):
    def __init__(self, name=None):
        super(CompositeMetric, self).__init__(name)
        self._metrics = []

    def add_metric(self, metric):
        if not isinstance(metric, MetricBase):
            raise ValueError("metric should be MetricBase")
        self._metrics.append(metric)

    def update(self, preds, labels):
        for m in self._metrics:
            m.update(preds, labels)

    def eval(self):
        return [m.eval() for m in self._metrics]


class Precision(MetricBase):
    def __init__(self, name=None):
        super(Precision, self).__init__(name)
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        preds = np.asarray(preds)
        labels = np.asarray(labels)
        sample_num = labels.shape[0]
        for i in range(sample_num):
            pred = (preds.reshape(sample_num, -1)[i] > 0.5).astype("int32")
            label = labels.reshape(sample_num, -1)[i]
            if pred == 1:
                if pred == label:
                    self.tp += 1
                else:
                    self.fp += 1

    def eval(self):
        ap = self.tp + self.fp
        return float(self.tp) / ap if ap != 0 else .0


class Recall(MetricBase):
    def __init__(self, name=None):
        super(Recall, self).__init__(name)
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        preds = np.asarray(preds)
        labels = np.asarray(labels)
        sample_num = labels.shape[0]
        for i in range(sample_num):
            pred = (preds.reshape(sample_num, -1)[i] > 0.5).astype("int32")
            label = labels.reshape(sample_num, -1)[i]
            if label == 1:
                if pred == label:
                    self.tp += 1
                else:
                    self.fn += 1

    def eval(self):
        recall = self.tp + self.fn
        return float(self.tp) / recall if recall != 0 else .0


class Accuracy(MetricBase):
    def __init__(self, name=None):
        super(Accuracy, self).__init__(name)
        self.value = .0
        self.weight = .0

    def update(self, value, weight):
        self.value += float(np.asarray(value).reshape(-1)[0]) * weight
        self.weight += weight

    def eval(self):
        if self.weight == 0:
            raise ValueError("Accuracy: weight is 0 (call update first)")
        return self.value / self.weight


class ChunkEvaluator(MetricBase):
    def __init__(self, name=None):
        super(ChunkEvaluator, self).__init__(name)
        self.num_infer_chunks = 0
        self.num_label_chunks = 0
        self.num_correct_chunks = 0

    def update(self, num_infer_chunks, num_label_chunks, num_correct_chunks):
        self.num_infer_chunks += int(np.asarray(num_infer_chunks).sum())
        self.num_label_chunks += int(np.asarray(num_label_chunks).sum())
        self.num_correct_chunks += int(np.asarray(num_correct_chunks).sum())

    def eval(self):
        precision = float(self.num_correct_chunks) / self.num_infer_chunks \
            if self.num_infer_chunks else 0.
        recall = float(self.num_correct_chunks) / self.num_label_chunks \
            if self.num_label_chunks else 0.
        f1_score = 2 * precision * recall / (precision + recall) \
            if self.num_correct_chunks else 0.
        return precision, recall, f1_score


class EditDistance(MetricBase):
    def __init__(self, name=None):
        super(EditDistance, self).__init__(name)
        self.total_distance = .0
        self.seq_num = 0
        self.instance_error = 0

    def update(self, distances, seq_num):
        distances = np.asarray(distances)
        seq_num = int(np.asarray(seq_num).sum())
        self.seq_num += seq_num
        self.instance_error += int(np.sum(distances > 0))
        self.total_distance += float(np.sum(distances))

    def eval(self):
        if self.seq_num == 0:
            raise ValueError("EditDistance: no data (call update first)")
        avg_distance = self.total_distance / self.seq_num
        avg_instance_error = self.instance_error / float(self.seq_num)
        return avg_distance, avg_instance_error


class DetectionMAP(MetricBase):
    def __init__(self, name=None):
        super(DetectionMAP, self).__init__(name)
        self.has_value = False
        self.value = .0
        self.weight = .0

    def update(self, value, weight=1):
        if not _is_numpy_(np.asarray(value)):
            raise ValueError("value should be numpy-convertible")
        self.value += float(np.asarray(value).reshape(-1)[0])
        self.weight += weight
        self.has_value = True

    def eval(self):
        if self.weight == 0:
            raise ValueError("DetectionMAP: weight is 0")
        return self.value / self.weight


class Auc(MetricBase):
    """Host-side streaming AUC (reference metrics.py:Auc)."""

    def __init__(self, name=None, curve='ROC', num_thresholds=200):
        super(Auc, self).__init__(name)
        self._curve = curve
        self._num_thresholds = num_thresholds
        self.tp_list = np.zeros((num_thresholds,))
        self.fn_list = np.zeros((num_thresholds,))
        self.tn_list = np.zeros((num_thresholds,))
        self.fp_list = np.zeros((num_thresholds,))

    def update(self, preds, labels):
        preds = np.asarray(preds)
        labels = np.asarray(labels).reshape(-1)
        kepsilon = 1e-7
        thresholds = [(i + 1) * 1.0 / (self._num_thresholds - 1)
                      for i in range(self._num_thresholds - 2)]
        thresholds = [0.0 - kepsilon] + thresholds + [1.0 + kepsilon]
        p1 = preds[:, 1] if preds.ndim == 2 and preds.shape[1] >= 2 \
            else preds.reshape(-1)
        for idx_thresh, thresh in enumerate(thresholds):
            tp = np.sum((labels > 0) & (p1 >= thresh))
            fn = np.sum((labels > 0) & (p1 < thresh))
            tn = np.sum((labels <= 0) & (p1 < thresh))
            fp = np.sum((labels <= 0) & (p1 >= thresh))
            self.tp_list[idx_thresh] += tp
            self.fn_list[idx_thresh] += fn
            self.tn_list[idx_thresh] += tn
            self.fp_list[idx_thresh] += fp

    def eval(self):
        epsilon = 1e-6
        num_thresholds = self._num_thresholds
        tpr = (self.tp_list.astype("float32") +
               epsilon) / (self.tp_list + self.fn_list + epsilon)
        fpr = self.fp_list.astype("float32") / (
            self.fp_list + self.tn_list + epsilon)
        auc_value = 0
        for i in range(num_thresholds - 1):
            dx = fpr[i] - fpr[i + 1]
            y = (tpr[i] + tpr[i + 1]) / 2
            auc_value += dx * y
        return auc_value
