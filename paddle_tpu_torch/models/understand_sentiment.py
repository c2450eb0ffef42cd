"""Sentiment classification conv net (Fluid book ch06).

Parity: reference python/paddle/fluid/tests/book/
test_understand_sentiment.py (convolution_net) and the JAX package's
models/understand_sentiment.py, op for op: embedding, two
sequence_conv_pools (filter sizes 3 and 4, tanh, sqrt pooling), a softmax
fc over both, Adagrad.
"""
from .. import fluid
from ..batch import batch
from ..dataset import imdb
from ..reader import shuffle

__all__ = ['convolution_net', 'get_model']


def convolution_net(data, label, input_dim, class_dim=2, emb_dim=32,
                    hid_dim=32):
    emb = fluid.layers.embedding(input=data, size=[input_dim, emb_dim])
    conv_3 = fluid.nets.sequence_conv_pool(input=emb, num_filters=hid_dim,
                                           filter_size=3, act="tanh",
                                           pool_type="sqrt")
    conv_4 = fluid.nets.sequence_conv_pool(input=emb, num_filters=hid_dim,
                                           filter_size=4, act="tanh",
                                           pool_type="sqrt")
    prediction = fluid.layers.fc(input=[conv_3, conv_4], size=class_dim,
                                 act="softmax")
    cost = fluid.layers.cross_entropy(input=prediction, label=label)
    avg_cost = fluid.layers.mean(x=cost)
    accuracy = fluid.layers.accuracy(input=prediction, label=label)
    return avg_cost, accuracy, prediction


def get_model(batch_size=32, learning_rate=0.002):
    """In the default programs. Returns (avg_cost, accuracy, train_reader,
    test_reader, the feed names)."""
    word_dict = imdb.word_dict()
    data = fluid.layers.data(name="words", shape=[1], dtype="int64",
                             lod_level=1)
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    avg_cost, accuracy, _ = convolution_net(data, label, len(word_dict))
    fluid.default_main_program().clone(for_test=True)
    fluid.optimizer.Adagrad(learning_rate=learning_rate).minimize(avg_cost)
    train_reader = batch(shuffle(imdb.train(word_dict), buf_size=1000),
                         batch_size=batch_size)
    test_reader = batch(imdb.test(word_dict), batch_size=batch_size)
    return (avg_cost, accuracy, train_reader, test_reader,
            ['words', 'label'])
