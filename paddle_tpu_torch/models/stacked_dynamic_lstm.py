"""Stacked LSTM for IMDB sentiment.

Parity: reference benchmark/fluid/models/stacked_dynamic_lstm.py
(get_model:46) and the JAX package's models/stacked_dynamic_lstm.py, op for
op: embedding, a tanh fc, per layer an fc to the four gates and one
dynamic_lstm (no peepholes), the last step pooled, a softmax fc, Adam.
"""
from .. import fluid
from ..batch import batch
from ..dataset import imdb
from ..reader import shuffle

__all__ = ['get_model', 'lstm_net', 'crop_sentence']


def crop_sentence(reader, crop_size):
    """The reader's samples shorter than crop_size."""
    def __impl__():
        for item in reader():
            if len(item[0]) < crop_size:
                yield item
    return __impl__


def lstm_net(data, dict_dim, lstm_size=512, emb_dim=512, stacked_num=1):
    sentence = fluid.layers.embedding(input=data, size=[dict_dim, emb_dim])
    sentence = fluid.layers.fc(input=sentence, size=lstm_size, act='tanh')
    inputs = sentence
    for _ in range(stacked_num):
        gates = fluid.layers.fc(input=inputs, size=lstm_size * 4,
                                bias_attr=True)
        hidden, _ = fluid.layers.dynamic_lstm(
            input=gates, size=lstm_size * 4, use_peepholes=False)
        inputs = hidden
    last = fluid.layers.sequence_pool(inputs, 'last')
    return fluid.layers.fc(input=last, size=2, act='softmax')


def get_model(batch_size=32, lstm_size=512, emb_dim=512, crop_size=1500):
    """In the default programs: feeds `words` (int64, lod_level 1) and
    `label`. Returns (loss, the for_test clone taken before the optimizer,
    train_reader, test_reader, batch accuracy)."""
    word_dict = imdb.word_dict()
    data = fluid.layers.data(name="words", shape=[1], lod_level=1,
                             dtype='int64')
    label = fluid.layers.data(name='label', shape=[1], dtype='int64')
    logit = lstm_net(data, len(word_dict), lstm_size, emb_dim)
    loss = fluid.layers.mean(
        fluid.layers.cross_entropy(input=logit, label=label))
    batch_acc = fluid.layers.accuracy(input=logit, label=label)

    inference_program = fluid.default_main_program().clone(for_test=True)
    fluid.optimizer.Adam().minimize(loss)

    train_reader = batch(
        shuffle(crop_sentence(imdb.train(word_dict), crop_size),
                buf_size=25000),
        batch_size=batch_size)
    test_reader = batch(crop_sentence(imdb.test(word_dict), crop_size),
                        batch_size=batch_size)
    return loss, inference_program, train_reader, test_reader, batch_acc
