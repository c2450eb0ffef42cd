"""MNIST LeNet.

Parity: reference benchmark/fluid/models/mnist.py (cnn_model:37,
get_model:68) and the JAX package's models/mnist.py.
"""
import numpy as np

from .. import fluid
from ..batch import batch
from ..dataset import mnist

__all__ = ['cnn_model', 'get_model']


def cnn_model(data):
    """Two conv(5x5)+relu+max-pool(2) stages (20, then 50 filters) and a
    softmax fc to 10 classes; returns the class probabilities."""
    conv_pool_1 = fluid.nets.simple_img_conv_pool(
        input=data, filter_size=5, num_filters=20, pool_size=2,
        pool_stride=2, act="relu")
    conv_pool_2 = fluid.nets.simple_img_conv_pool(
        input=conv_pool_1, filter_size=5, num_filters=50, pool_size=2,
        pool_stride=2, act="relu")
    SIZE = 10
    input_shape = conv_pool_2.shape
    param_shape = [int(np.prod(input_shape[1:]))] + [SIZE]
    scale = (2.0 / (param_shape[0] ** 2 * SIZE)) ** 0.5
    return fluid.layers.fc(
        input=conv_pool_2, size=SIZE, act="softmax",
        param_attr=fluid.ParamAttr(
            initializer=fluid.initializer.NormalInitializer(
                loc=0.0, scale=scale)))


def get_model(batch_size=128, learning_rate=0.001):
    """LeNet on [1, 28, 28] images, cross_entropy, accuracy, Adam, in the
    default programs. Returns (avg_cost, the for_test clone taken before
    the optimizer, train_reader, test_reader, batch accuracy)."""
    images = fluid.layers.data(name='pixel', shape=[1, 28, 28],
                               dtype='float32')
    label = fluid.layers.data(name='label', shape=[1], dtype='int64')
    predict = cnn_model(images)
    cost = fluid.layers.cross_entropy(input=predict, label=label)
    avg_cost = fluid.layers.mean(x=cost)
    batch_acc = fluid.layers.accuracy(input=predict, label=label)

    inference_program = fluid.default_main_program().clone(for_test=True)
    opt = fluid.optimizer.AdamOptimizer(learning_rate=learning_rate,
                                        beta1=0.9, beta2=0.999)
    opt.minimize(avg_cost)

    train_reader = batch(mnist.train(), batch_size=batch_size)
    test_reader = batch(mnist.test(), batch_size=batch_size)
    return avg_cost, inference_program, train_reader, test_reader, batch_acc
