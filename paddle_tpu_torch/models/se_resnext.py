"""SE-ResNeXt-50 (squeeze-and-excitation ResNeXt), on flowers.

Parity: the JAX package's models/se_resnext.py, the topology the reference
python/paddle/fluid/tests/unittests/test_parallel_executor.py trains as
its heavyweight ParallelExecutor workload (cardinality-32 bottlenecks and
SE blocks), built with the same layer calls. The grouped convolutions run
as cuDNN library calls on the card, fp32 with TF32 off.
"""
from .. import fluid
from ..batch import batch
from ..dataset import flowers

__all__ = ['SE_ResNeXt', 'get_model']


def conv_bn_layer(input, num_filters, filter_size, stride=1, groups=1,
                  act=None):
    conv = fluid.layers.conv2d(input=input, num_filters=num_filters,
                               filter_size=filter_size, stride=stride,
                               padding=(filter_size - 1) // 2, groups=groups,
                               act=None, bias_attr=False)
    return fluid.layers.batch_norm(input=conv, act=act)


def squeeze_excitation(input, num_channels, reduction_ratio):
    pool = fluid.layers.pool2d(input=input, pool_type='avg',
                               global_pooling=True)
    squeeze = fluid.layers.fc(input=pool,
                              size=num_channels // reduction_ratio,
                              act='relu')
    excitation = fluid.layers.fc(input=squeeze, size=num_channels,
                                 act='sigmoid')
    excitation = fluid.layers.reshape(excitation,
                                      shape=[-1, num_channels, 1, 1])
    return fluid.layers.elementwise_mul(x=input, y=excitation, axis=0)


def shortcut(input, ch_out, stride):
    ch_in = input.shape[1]
    if ch_in != ch_out:
        return conv_bn_layer(input, ch_out, 1, stride)
    return input


def bottleneck_block(input, num_filters, stride, cardinality,
                     reduction_ratio):
    conv0 = conv_bn_layer(input, num_filters, 1, act='relu')
    conv1 = conv_bn_layer(conv0, num_filters, 3, stride=stride,
                          groups=cardinality, act='relu')
    conv2 = conv_bn_layer(conv1, num_filters * 2, 1, act=None)
    scale = squeeze_excitation(conv2, num_filters * 2, reduction_ratio)
    short = shortcut(input, num_filters * 2, stride)
    return fluid.layers.elementwise_add(x=short, y=scale, act='relu')


def SE_ResNeXt(input, class_dim, depth=50, cardinality=32,
               reduction_ratio=16):
    cfg = {50: [3, 4, 6, 3], 152: [3, 8, 36, 3]}
    blocks = cfg[depth]
    num_filters = [128, 256, 512, 1024]
    conv = conv_bn_layer(input, num_filters=64, filter_size=7, stride=2,
                         act='relu')
    conv = fluid.layers.pool2d(input=conv, pool_size=3, pool_stride=2,
                               pool_padding=1, pool_type='max')
    for block in range(len(blocks)):
        for i in range(blocks[block]):
            conv = bottleneck_block(conv, num_filters[block],
                                    2 if i == 0 and block != 0 else 1,
                                    cardinality, reduction_ratio)
    pool = fluid.layers.pool2d(input=conv, pool_type='avg',
                               global_pooling=True)
    drop = fluid.layers.dropout(x=pool, dropout_prob=0.2)
    return fluid.layers.fc(input=drop, size=class_dim, act='softmax')


def get_model(batch_size=16, class_dim=102, learning_rate=0.01):
    """Build the train graph and readers in the default programs: the
    flowers reader at 3x224x224, cross_entropy of the softmax, mean,
    accuracy, Momentum(learning_rate, 0.9). Returns (avg_cost, accuracy,
    train_reader, test_reader, feed names)."""
    img = fluid.layers.data(name='data', shape=[3, 224, 224],
                            dtype='float32')
    label = fluid.layers.data(name='label', shape=[1], dtype='int64')
    out = SE_ResNeXt(img, class_dim)
    avg_cost = fluid.layers.mean(
        fluid.layers.cross_entropy(input=out, label=label))
    acc = fluid.layers.accuracy(input=out, label=label)
    fluid.optimizer.Momentum(learning_rate=learning_rate,
                             momentum=0.9).minimize(avg_cost)
    train_reader = batch(flowers.train(), batch_size=batch_size)
    test_reader = batch(flowers.test(), batch_size=batch_size)
    return avg_cost, acc, train_reader, test_reader, ['data', 'label']
