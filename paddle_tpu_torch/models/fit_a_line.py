"""Linear regression on UCI housing (Fluid book ch01).

Parity: reference python/paddle/fluid/tests/book/test_fit_a_line.py and the
JAX package's models/fit_a_line.py.
"""
from .. import fluid, reader
from ..batch import batch
from ..dataset import uci_housing

__all__ = ['get_model']


def get_model(batch_size=20, learning_rate=0.01):
    """fc(13 -> 1), square_error_cost, mean, SGD, in the default programs.
    Returns (avg_cost, the for_test clone taken before the optimizer,
    train_reader (shuffled, buffer 500), test_reader, feed names)."""
    x = fluid.layers.data(name='x', shape=[13], dtype='float32')
    y = fluid.layers.data(name='y', shape=[1], dtype='float32')
    y_predict = fluid.layers.fc(input=x, size=1, act=None)
    cost = fluid.layers.square_error_cost(input=y_predict, label=y)
    avg_cost = fluid.layers.mean(x=cost)
    inference_program = fluid.default_main_program().clone(for_test=True)
    fluid.optimizer.SGD(learning_rate=learning_rate).minimize(avg_cost)
    train_reader = batch(reader.shuffle(uci_housing.train(), buf_size=500),
                         batch_size=batch_size)
    test_reader = batch(uci_housing.test(), batch_size=batch_size)
    return avg_cost, inference_program, train_reader, test_reader, ['x', 'y']
