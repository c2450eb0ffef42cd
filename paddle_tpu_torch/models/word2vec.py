"""N-gram word embedding model (Fluid book ch04 word2vec).

Parity: reference python/paddle/fluid/tests/book/test_word2vec.py and the
JAX package's models/word2vec.py, op for op: four context words read one
`shared_w` table, their embeddings concatenated, a sigmoid fc and a
softmax fc over the vocabulary, SGD. Built from the layers with
is_sparse=True (the reference book's setting), the four lookups'
gradients reach shared_w as one merged SparseRows update.
"""
from .. import fluid
from ..batch import batch
from ..dataset import imikolov

__all__ = ['ngram_net', 'get_model']

EMBED_SIZE = 32
HIDDEN_SIZE = 256
N = 5


def ngram_net(words, dict_size, embed_size=EMBED_SIZE):
    embeds = []
    for w in words[:-1]:
        embeds.append(fluid.layers.embedding(
            input=w, size=[dict_size, embed_size],
            param_attr=fluid.ParamAttr(name='shared_w')))
    concat = fluid.layers.concat(input=embeds, axis=1)
    hidden = fluid.layers.fc(input=concat, size=HIDDEN_SIZE, act='sigmoid')
    predict = fluid.layers.softmax(
        fluid.layers.fc(input=hidden, size=dict_size))
    return predict


def get_model(batch_size=64, learning_rate=0.001):
    """In the default programs. Returns (avg_cost, the for_test program,
    train_reader, test_reader, the feed names word_0..word_4)."""
    word_dict = imikolov.build_dict()
    dict_size = len(word_dict)
    words = [fluid.layers.data(name='word_%d' % i, shape=[1], dtype='int64')
             for i in range(N)]
    predict = ngram_net(words, dict_size)
    cost = fluid.layers.cross_entropy(input=predict, label=words[-1])
    avg_cost = fluid.layers.mean(x=cost)
    inference_program = fluid.default_main_program().clone(for_test=True)
    fluid.optimizer.SGD(learning_rate=learning_rate).minimize(avg_cost)
    train_reader = batch(imikolov.train(word_dict, N), batch_size)
    test_reader = batch(imikolov.test(word_dict, N), batch_size)
    feeds = ['word_%d' % i for i in range(N)]
    return avg_cost, inference_program, train_reader, test_reader, feeds
