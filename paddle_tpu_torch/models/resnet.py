"""ResNet for cifar10 and imagenet, the flagship image benchmark.

Parity: reference benchmark/fluid/models/resnet.py (conv_bn_layer:33,
shortcut:45, basicblock:53, bottleneck:60, resnet_imagenet:75,
resnet_cifar10:102) and the JAX package's models/resnet.py, built with the
same layer calls. Convolutions, pools and batch norm run as cuDNN library
calls on the card (fluid/ops_impl/nn_ops.py), fp32 with TF32 off, or bf16
under AMP.
"""
from .. import fluid
from ..batch import batch
from ..dataset import cifar, flowers

__all__ = ['resnet_cifar10', 'resnet_imagenet', 'get_model']


def conv_bn_layer(input, ch_out, filter_size, stride, padding, act='relu',
                  data_format='NCHW'):
    conv1 = fluid.layers.conv2d(
        input=input, filter_size=filter_size, num_filters=ch_out,
        stride=stride, padding=padding, act=None, bias_attr=False,
        data_format=data_format)
    return fluid.layers.batch_norm(input=conv1, act=act,
                                   data_layout=data_format)


def shortcut(input, ch_out, stride, data_format='NCHW'):
    ch_in = input.shape[-1 if data_format == 'NHWC' else 1]
    if ch_in != ch_out:
        return conv_bn_layer(input, ch_out, 1, stride, 0, None,
                             data_format=data_format)
    return input


def basicblock(input, ch_out, stride, data_format='NCHW'):
    short = shortcut(input, ch_out, stride, data_format)
    conv1 = conv_bn_layer(input, ch_out, 3, stride, 1,
                          data_format=data_format)
    conv2 = conv_bn_layer(conv1, ch_out, 3, 1, 1, act=None,
                          data_format=data_format)
    return fluid.layers.elementwise_add(x=short, y=conv2, act='relu')


def bottleneck(input, ch_out, stride, data_format='NCHW'):
    short = shortcut(input, ch_out * 4, stride, data_format)
    conv1 = conv_bn_layer(input, ch_out, 1, stride, 0,
                          data_format=data_format)
    conv2 = conv_bn_layer(conv1, ch_out, 3, 1, 1, data_format=data_format)
    conv3 = conv_bn_layer(conv2, ch_out * 4, 1, 1, 0, act=None,
                          data_format=data_format)
    return fluid.layers.elementwise_add(x=short, y=conv3, act='relu')


def layer_warp(block_func, input, ch_out, count, stride, data_format='NCHW'):
    res_out = block_func(input, ch_out, stride, data_format)
    for i in range(1, count):
        res_out = block_func(res_out, ch_out, 1, data_format)
    return res_out


def resnet_imagenet(input, class_dim, depth=50, data_format='NCHW'):
    """data_format='NHWC' runs the whole tower channels-last (feed
    [N, H, W, 3]) with the same OIHW weights as NCHW."""
    cfg = {
        18: ([2, 2, 2, 1], basicblock),
        34: ([3, 4, 6, 3], basicblock),
        50: ([3, 4, 6, 3], bottleneck),
        101: ([3, 4, 23, 3], bottleneck),
        152: ([3, 8, 36, 3], bottleneck),
    }
    stages, block_func = cfg[depth]
    conv1 = conv_bn_layer(input, ch_out=64, filter_size=7, stride=2,
                          padding=3, data_format=data_format)
    pool1 = fluid.layers.pool2d(input=conv1, pool_type='avg', pool_size=3,
                                pool_stride=2, data_format=data_format)
    res1 = layer_warp(block_func, pool1, 64, stages[0], 1, data_format)
    res2 = layer_warp(block_func, res1, 128, stages[1], 2, data_format)
    res3 = layer_warp(block_func, res2, 256, stages[2], 2, data_format)
    res4 = layer_warp(block_func, res3, 512, stages[3], 2, data_format)
    pool2 = fluid.layers.pool2d(input=res4, pool_size=7, pool_type='avg',
                                pool_stride=1, global_pooling=True,
                                data_format=data_format)
    return fluid.layers.fc(input=pool2, size=class_dim, act='softmax')


def resnet_cifar10(input, class_dim, depth=32):
    assert (depth - 2) % 6 == 0
    n = (depth - 2) // 6
    conv1 = conv_bn_layer(input=input, ch_out=16, filter_size=3, stride=1,
                          padding=1)
    res1 = layer_warp(basicblock, conv1, 16, n, 1)
    res2 = layer_warp(basicblock, res1, 32, n, 2)
    res3 = layer_warp(basicblock, res2, 64, n, 2)
    pool = fluid.layers.pool2d(input=res3, pool_size=8, pool_type='avg',
                               pool_stride=1)
    return fluid.layers.fc(input=pool, size=class_dim, act='softmax')


def get_model(data_set='cifar10', depth=None, batch_size=32,
              learning_rate=0.01, use_bf16=False):
    """Build the train graph and readers in the default programs
    (reference resnet.py:get_model): cross_entropy of the softmax, mean,
    accuracy, Momentum(learning_rate, 0.9). imagenet and flowers read the
    flowers reader at 3x224x224 (1000 or 102 classes), cifar10 the cifar
    reader at 3x32x32. use_bf16 is accepted and not read, as in the JAX
    package (its resnet.py:101): bf16 training is a bfloat16 data var and
    fluid.amp.decorate_program, as the JAX bench.py:215-253 builds it.
    Returns (avg_cost, accuracy, train_reader, test_reader)."""
    if data_set == "cifar10":
        class_dim = 10
        dshape = [3, 32, 32]
        model = resnet_cifar10
        depth = depth or 32
        train_reader = cifar.train10()
        test_reader = cifar.test10()
    else:
        class_dim = 102 if data_set == 'flowers' else 1000
        dshape = [3, 224, 224]
        model = resnet_imagenet
        depth = depth or 50
        train_reader = flowers.train()
        test_reader = flowers.test()

    input = fluid.layers.data(name='data', shape=dshape, dtype='float32')
    label = fluid.layers.data(name='label', shape=[1], dtype='int64')
    predict = model(input, class_dim, depth=depth)
    cost = fluid.layers.cross_entropy(input=predict, label=label)
    avg_cost = fluid.layers.mean(x=cost)
    batch_acc = fluid.layers.accuracy(input=predict, label=label)

    optimizer = fluid.optimizer.Momentum(learning_rate=learning_rate,
                                         momentum=0.9)
    optimizer.minimize(avg_cost)

    batched_train = batch(train_reader, batch_size=batch_size)
    batched_test = batch(test_reader, batch_size=batch_size)
    return avg_cost, batch_acc, batched_train, batched_test
