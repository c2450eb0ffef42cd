"""VGG-16 with batch norm and dropout, on cifar10 or flowers.

Parity: reference benchmark/fluid/models/vgg.py (vgg16_bn_drop:29,
get_model:55) and the JAX package's models/vgg.py, built with the same
layer calls. Convolutions, pools and batch norm run as cuDNN library calls
on the card (fluid/ops_impl/nn_ops.py), fp32 with TF32 off.
"""
from .. import fluid
from ..batch import batch
from ..dataset import cifar, flowers

__all__ = ['vgg16_bn_drop', 'get_model']


def vgg16_bn_drop(input):
    def conv_block(input, num_filter, groups, dropouts):
        return fluid.nets.img_conv_group(
            input=input, pool_size=2, pool_stride=2,
            conv_num_filter=[num_filter] * groups, conv_filter_size=3,
            conv_act='relu', conv_with_batchnorm=True,
            conv_batchnorm_drop_rate=dropouts, pool_type='max')

    conv1 = conv_block(input, 64, 2, [0.3, 0])
    conv2 = conv_block(conv1, 128, 2, [0.4, 0])
    conv3 = conv_block(conv2, 256, 3, [0.4, 0.4, 0])
    conv4 = conv_block(conv3, 512, 3, [0.4, 0.4, 0])
    conv5 = conv_block(conv4, 512, 3, [0.4, 0.4, 0])

    drop = fluid.layers.dropout(x=conv5, dropout_prob=0.5)
    fc1 = fluid.layers.fc(input=drop, size=512, act=None)
    bn = fluid.layers.batch_norm(input=fc1, act='relu')
    drop2 = fluid.layers.dropout(x=bn, dropout_prob=0.5)
    fc2 = fluid.layers.fc(input=drop2, size=512, act=None)
    return fc2


def get_model(data_set='cifar10', batch_size=32, learning_rate=1e-3):
    """Build the train graph and readers in the default programs: softmax
    fc, cross_entropy, mean, accuracy, Adam(learning_rate). cifar10 reads
    3x32x32 images of 10 classes, any other data_set the flowers reader
    at 3x224x224, 102 classes. Returns (avg_cost, the for_test clone made
    before the optimizer, train_reader, test_reader, accuracy)."""
    if data_set == "cifar10":
        classdim = 10
        data_shape = [3, 32, 32]
        train_reader = cifar.train10()
        test_reader = cifar.test10()
    else:
        classdim = 102
        data_shape = [3, 224, 224]
        train_reader = flowers.train()
        test_reader = flowers.test()

    images = fluid.layers.data(name='data', shape=data_shape, dtype='float32')
    label = fluid.layers.data(name='label', shape=[1], dtype='int64')
    net = vgg16_bn_drop(images)
    predict = fluid.layers.fc(input=net, size=classdim, act='softmax')
    cost = fluid.layers.cross_entropy(input=predict, label=label)
    avg_cost = fluid.layers.mean(x=cost)
    batch_acc = fluid.layers.accuracy(input=predict, label=label)

    inference_program = fluid.default_main_program().clone(for_test=True)
    optimizer = fluid.optimizer.Adam(learning_rate=learning_rate)
    optimizer.minimize(avg_cost)

    return (avg_cost, inference_program,
            batch(train_reader, batch_size=batch_size),
            batch(test_reader, batch_size=batch_size), batch_acc)
