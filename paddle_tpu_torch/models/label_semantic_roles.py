"""Semantic role labelling: a deep bidirectional LSTM with a linear-chain
CRF (Fluid book ch07).

Parity: reference python/paddle/fluid/tests/book/
test_label_semantic_roles.py and the JAX package's models/
label_semantic_roles.py, op for op. db_lstm: eight feature embeddings
(the six word slots read one frozen `emb` table) each through an fc,
summed; a stack of dynamic_lstms alternating in direction, each fed the
sum of two fcs over the layer below and its input (direct edges); two
tanh fcs to the label scores, summed. The loss is linear_chain_crf under
the `crfw` transition (its own learning rate), the decode crf_decoding
under the same weights.
"""
import numpy as np

from .. import fluid
from ..batch import batch
from ..dataset import conll05
from ..reader import shuffle

__all__ = ['db_lstm', 'get_model', 'load_pretrained_embedding', 'FEED_ORDER']

FEED_ORDER = ['word_data', 'ctx_n2_data', 'ctx_n1_data', 'ctx_0_data',
              'ctx_p1_data', 'ctx_p2_data', 'verb_data', 'mark_data',
              'target']

MARK_DICT_LEN = 2


def db_lstm(word, predicate, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2, mark,
            word_dict_len, label_dict_len, pred_dict_len,
            word_dim=32, mark_dim=5, hidden_dim=512, depth=8,
            embedding_name='emb'):
    predicate_embedding = fluid.layers.embedding(
        input=predicate, size=[pred_dict_len, word_dim], dtype='float32',
        param_attr='vemb')
    mark_embedding = fluid.layers.embedding(
        input=mark, size=[MARK_DICT_LEN, mark_dim], dtype='float32')

    word_input = [word, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2]
    emb_layers = [
        fluid.layers.embedding(
            size=[word_dict_len, word_dim], input=x,
            param_attr=fluid.ParamAttr(name=embedding_name, trainable=False))
        for x in word_input
    ]
    emb_layers.append(predicate_embedding)
    emb_layers.append(mark_embedding)

    hidden_0 = fluid.layers.sums(input=[
        fluid.layers.fc(input=emb, size=hidden_dim) for emb in emb_layers])

    lstm_0, _ = fluid.layers.dynamic_lstm(
        input=hidden_0, size=hidden_dim, candidate_activation='relu',
        gate_activation='sigmoid', cell_activation='sigmoid')

    # the stacked LSTMs with direct edges, alternating in direction
    input_tmp = [hidden_0, lstm_0]
    for i in range(1, depth):
        mix_hidden = fluid.layers.sums(input=[
            fluid.layers.fc(input=input_tmp[0], size=hidden_dim),
            fluid.layers.fc(input=input_tmp[1], size=hidden_dim),
        ])
        lstm, _ = fluid.layers.dynamic_lstm(
            input=mix_hidden, size=hidden_dim,
            candidate_activation='relu', gate_activation='sigmoid',
            cell_activation='sigmoid', is_reverse=((i % 2) == 1))
        input_tmp = [mix_hidden, lstm]

    feature_out = fluid.layers.sums(input=[
        fluid.layers.fc(input=input_tmp[0], size=label_dict_len, act='tanh'),
        fluid.layers.fc(input=input_tmp[1], size=label_dict_len, act='tanh'),
    ])
    return feature_out


def get_model(word_dim=32, mark_dim=5, hidden_dim=128, depth=4,
              mix_hidden_lr=1e-3, batch_size=10):
    """In the default programs: db_lstm, the CRF cost and its decode (no
    optimizer: the caller minimizes avg_cost). Returns (avg_cost,
    crf_decode, train_reader, FEED_ORDER)."""
    word_dict, verb_dict, label_dict = conll05.get_dict()

    def seq_data(name):
        return fluid.layers.data(name=name, shape=[1], dtype='int64',
                                 lod_level=1)

    word, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2, predicate, mark, target = \
        [seq_data(n) for n in FEED_ORDER]

    feature_out = db_lstm(word, predicate, ctx_n2, ctx_n1, ctx_0, ctx_p1,
                          ctx_p2, mark, len(word_dict), len(label_dict),
                          len(verb_dict), word_dim=word_dim,
                          mark_dim=mark_dim, hidden_dim=hidden_dim,
                          depth=depth)
    crf_cost = fluid.layers.linear_chain_crf(
        input=feature_out, label=target,
        param_attr=fluid.ParamAttr(name='crfw', learning_rate=mix_hidden_lr))
    avg_cost = fluid.layers.mean(crf_cost)

    crf_decode = fluid.layers.crf_decoding(
        input=feature_out, param_attr=fluid.ParamAttr(name='crfw'))

    train_reader = batch(shuffle(conll05.train(), buf_size=1024),
                         batch_size=batch_size)
    return avg_cost, crf_decode, train_reader, list(FEED_ORDER)


def load_pretrained_embedding(scope=None, embedding_name='emb'):
    """Load conll05's pretrained word embedding into the frozen `emb`
    table after the startup program ran (the reference book's
    load_parameter step: the table is trainable=False, so it would keep
    its random start otherwise), through
    scope.find_var(name).get_tensor().set(...): the table keeps its
    device and dtype. Columns are sliced, or tiled, to the model's
    word_dim. Returns the table's shape."""
    from ..fluid.executor import global_scope
    scope = scope or global_scope()
    var = scope.find_var(embedding_name)
    cur = None if var is None else scope._chain_get(embedding_name)
    if cur is None:
        raise ValueError('run the startup program before loading the '
                         'pretrained embedding')
    rows, cols = cur.shape
    # the file: a 16-byte header, then raw float32 [vocab, 32]
    with open(conll05.get_embedding(), 'rb') as f:
        f.read(16)
        emb = np.fromfile(f, dtype=np.float32).reshape(-1, 32)
    if emb.shape[1] < cols:
        emb = np.tile(emb, (1, -(-cols // emb.shape[1])))
    emb = emb[:rows, :cols]
    var.get_tensor().set(emb)
    return emb.shape
