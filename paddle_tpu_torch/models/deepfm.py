"""DeepFM / wide&deep CTR model with high-dimensional sparse features.

Parity: the JAX package's models/deepfm.py (BASELINE.json config 5):
deepfm, synthetic_ctr_reader and get_model build the same Program and read
the same rows. With is_sparse=True both FM tables train through the
touched-rows path (fluid/executor.py): their optimizer takes a SparseRows
gradient, merged and applied by the fused sparse kernels
(ops/kernels/sparse_optim.py) on the card.
"""
import numpy as np

from ..batch import batch
from .. import fluid
from ..dataset import common
from ..fluid import layers

__all__ = ['deepfm', 'training_program', 'get_model', 'synthetic_ctr_reader']

NUM_FIELDS = 26
VOCAB = 100000


def deepfm(feat_ids, label, num_fields=NUM_FIELDS, vocab_size=VOCAB,
           embed_dim=10, hidden=[400, 400, 400], dist_axis=None,
           is_sparse=False):
    """feat_ids: int64 [B, num_fields]; one id per field. Returns
    (avg_cost, prob, logit).

    dist_axis (row-sharding both FM tables over a mesh axis) needs the
    parallel slice of the port and raises NotImplementedError."""
    if dist_axis is not None:
        raise NotImplementedError(
            'deepfm(dist_axis=...): row-sharded tables are not ported yet')

    def _table(name):
        return fluid.ParamAttr(name=name)

    # ---- FM first order: w[ids] summed over fields
    first_w = layers.embedding(input=feat_ids, size=[vocab_size, 1],
                               is_sparse=is_sparse, is_distributed=False,
                               param_attr=_table('fm_first_w'))
    # [B, F, 1] -> [B, 1]
    first = layers.reduce_sum(first_w, dim=1)

    # ---- FM second order: 0.5 * ((sum_f v_f)^2 - sum_f v_f^2)
    emb = layers.embedding(input=feat_ids, size=[vocab_size, embed_dim],
                           is_sparse=is_sparse, is_distributed=False,
                           param_attr=_table('fm_embed'))
    sum_v = layers.reduce_sum(emb, dim=1)                    # [B, D]
    sum_v_sq = layers.square(sum_v)
    sq_v = layers.square(emb)
    sq_sum_v = layers.reduce_sum(sq_v, dim=1)
    second = layers.scale(
        layers.elementwise_sub(sum_v_sq, sq_sum_v), scale=0.5)  # [B, D]
    second = layers.reduce_sum(second, dim=1, keep_dim=True)    # [B, 1]

    # ---- deep part: MLP over concatenated field embeddings
    deep = layers.reshape(emb, shape=[-1, num_fields * embed_dim])
    for h in hidden:
        deep = layers.fc(input=deep, size=h, act='relu')
    deep_out = layers.fc(input=deep, size=1, act=None)

    logit = layers.elementwise_add(
        layers.elementwise_add(first, second), deep_out)
    loss = layers.sigmoid_cross_entropy_with_logits(
        logit, layers.cast(label, 'float32'))
    avg_cost = layers.mean(loss)
    prob = layers.sigmoid(logit)
    return avg_cost, prob, logit


def synthetic_ctr_reader(n=4096, num_fields=NUM_FIELDS, vocab=VOCAB,
                         tag='train'):
    """Deterministic learnable CTR stream: latent weight per bucket."""
    def reader():
        rng = common.synthetic_rng('ctr_' + tag)
        w = common.synthetic_rng('ctr_w').randn(4096) * 0.7
        for _ in range(n):
            ids = rng.randint(0, vocab, size=num_fields).astype('int64')
            score = w[ids % 4096].sum()
            p = 1.0 / (1.0 + np.exp(-score))
            label = int(rng.rand() < p)
            yield ids, label
    return reader


def training_program(is_sparse=True, optimizer='adam', learning_rate=1e-3,
                     **model):
    """get_model's training program in the default programs: deepfm (at
    its own widths unless `model` names others, e.g. num_fields, vocab_size,
    embed_dim, hidden) with both FM tables is_sparse as given, auc over
    [1 - prob, prob], and the optimizer 'adam' or 'adagrad' at
    learning_rate. The defaults are the sparse program the JAX package's
    bench.py:701-706 trains. Returns (avg_cost, auc, prob, feed names)."""
    feat_ids = layers.data(name='feat_ids',
                           shape=[model.get('num_fields', NUM_FIELDS)],
                           dtype='int64')
    label = layers.data(name='label', shape=[1], dtype='int64')
    avg_cost, prob, _ = deepfm(feat_ids, label, is_sparse=is_sparse,
                               **model)
    auc = layers.auc(prob if prob.shape[-1] == 2 else
                     layers.concat([layers.scale(prob, -1.0, 1.0), prob],
                                   axis=1), label)
    opt = {'adam': fluid.optimizer.Adam,
           'adagrad': fluid.optimizer.Adagrad}[optimizer]
    opt(learning_rate=learning_rate).minimize(avg_cost)
    return avg_cost, auc, prob, ['feat_ids', 'label']


def get_model(batch_size=256, embed_dim=10, learning_rate=1e-3):
    """The JAX package's models/deepfm.py:get_model (dense tables, Adam; its
    embed_dim is not passed on, as there): the training program in the
    default programs, and its readers. Returns (avg_cost, auc,
    train_reader, test_reader, feed names)."""
    avg_cost, auc, _, feeds = training_program(
        is_sparse=False, learning_rate=learning_rate)
    train_reader = batch(synthetic_ctr_reader(tag='train'),
                         batch_size=batch_size)
    test_reader = batch(synthetic_ctr_reader(1024, tag='test'),
                        batch_size=batch_size)
    return avg_cost, auc, train_reader, test_reader, feeds
