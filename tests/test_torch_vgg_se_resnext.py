"""The nets and blocks of VGG-16 and SE-ResNeXt-50, and the nets'
attention, trained in both packages on the CPU at narrow widths, dropout
0: from the JAX package's startup weights, the losses and every
persistable (weights, velocities, batch norm's running stats) over 3
Momentum steps at 1e-4 of each tensor's max(|x|, 1) (the image models'
tolerance, tests/test_torch_image_models.py: fp32 convolutions summed in
other orders), the programs op for op:

  * nets.img_conv_group: two 3x3 convolutions with batch norm, one
    followed by dropout 0, and a 2x2 max pool (VGG's block);
  * models/se_resnext.bottleneck_block: cardinality 4 (a grouped 3x3
    convolution), an SE block of reduction 4 and a projection shortcut,
    stride 2;
  * nets.scaled_dot_product_attention with 2 heads (one flash_attention
    op, the path that launches the attention kernels on the card) and
    with 1 head (the matmul / softmax chain);
  * nets.glu.
The full models' programs are held op for op in
tests/test_torch_image_models.py.
"""
import numpy as np
import pytest

import jax  # noqa: F401  (conftest pins it to the CPU)

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import framework as jframework
from paddle_tpu.fluid import unique_name as junique
from paddle_tpu.fluid.executor import Scope as JScope
from paddle_tpu.models import se_resnext as jse

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import framework as tframework
from paddle_tpu_torch.fluid import unique_name as tunique
from paddle_tpu_torch.models import se_resnext as tse

from test_torch_training import _assert_same_program

JAX = (jfluid, jframework, junique, jse)
PORT = (tfluid, tframework, tunique, tse)
TOL = 1e-4


def _conv_group(fluid, se):
    x = fluid.layers.data(name='x', shape=[3, 8, 8])
    label = fluid.layers.data(name='label', shape=[1], dtype='int64')
    y = fluid.nets.img_conv_group(
        input=x, conv_num_filter=[4, 6], pool_size=2, pool_stride=2,
        conv_act='relu', conv_with_batchnorm=True,
        conv_batchnorm_drop_rate=[0.0, 0.0], pool_type='max')
    prob = fluid.layers.fc(input=y, size=5, act='softmax')
    return {'x': (3, 8, 8)}, prob, label


def _se_block(fluid, se):
    x = fluid.layers.data(name='x', shape=[8, 8, 8])
    label = fluid.layers.data(name='label', shape=[1], dtype='int64')
    y = se.bottleneck_block(x, num_filters=8, stride=2, cardinality=4,
                            reduction_ratio=4)
    pool = fluid.layers.pool2d(input=y, pool_type='avg', global_pooling=True)
    prob = fluid.layers.fc(input=pool, size=5, act='softmax')
    return {'x': (8, 8, 8)}, prob, label


def _attention(heads):
    def build(fluid, se):
        q = fluid.layers.data(name='q', shape=[6, 16])
        k = fluid.layers.data(name='k', shape=[6, 16])
        v = fluid.layers.data(name='v', shape=[6, 16])
        label = fluid.layers.data(name='label', shape=[1], dtype='int64')
        ctx = fluid.nets.scaled_dot_product_attention(q, k, v,
                                                      num_heads=heads)
        pooled = fluid.layers.reduce_mean(ctx, dim=1)
        prob = fluid.layers.fc(input=pooled, size=5, act='softmax')
        return {'q': (6, 16), 'k': (6, 16), 'v': (6, 16)}, prob, label
    return build


def _glu(fluid, se):
    x = fluid.layers.data(name='x', shape=[12])
    label = fluid.layers.data(name='label', shape=[1], dtype='int64')
    h = fluid.nets.glu(fluid.layers.fc(input=x, size=16), dim=-1)
    prob = fluid.layers.fc(input=h, size=5, act='softmax')
    return {'x': (12,)}, prob, label


NETS = {'img_conv_group': _conv_group, 'se_bottleneck': _se_block,
        'attention_2_heads': _attention(2), 'attention_1_head': _attention(1),
        'glu': _glu}


def _build(pkg, net):
    fluid, framework, unique_name, se = pkg
    main, startup = framework.Program(), framework.Program()
    with unique_name.guard(), framework.program_guard(main, startup):
        shapes, prob, label = NETS[net](fluid, se)
        loss = fluid.layers.mean(fluid.layers.cross_entropy(prob, label))
        fluid.optimizer.Momentum(learning_rate=0.05,
                                 momentum=0.9).minimize(loss)
    return main, startup, loss.name, shapes


def _feeds(shapes, n, batch=4):
    r = np.random.RandomState(5)
    return [dict({k: r.randn(batch, *s).astype('float32')
                  for k, s in sorted(shapes.items())},
                 label=r.randint(0, 5, (batch, 1)).astype('int64'))
            for _ in range(n)]


@pytest.mark.parametrize('net', sorted(NETS))
def test_net_trains_as_the_jax_package(net):
    jmain, jstart, jloss, shapes = _build(JAX, net)
    tmain, tstart, tloss, _ = _build(PORT, net)
    _assert_same_program(jmain, tmain)
    _assert_same_program(jstart, tstart)
    types = [op.type for op in tmain.global_block().ops]
    if net == 'attention_2_heads':
        assert types.count('flash_attention') == 1
    if net == 'attention_1_head':
        assert 'flash_attention' not in types and 'softmax' in types
    if net == 'se_bottleneck':
        groups = [op.attrs['groups'] for op in tmain.global_block().ops
                  if op.type == 'conv2d']
        assert sorted(groups) == [1, 1, 1, 4]
    feeds = _feeds(shapes, 3)
    jscope = JScope()
    with jfluid.scope_guard(jscope):
        jexe = jfluid.Executor(jfluid.CPUPlace())
        jexe.run(jstart)
        init = {n: np.array(v, copy=True) for n, v in jscope.vars.items()}
        want = [float(np.asarray(jexe.run(jmain, feed=f,
                                          fetch_list=[jloss])[0])[0])
                for f in feeds]
        final = {n: np.array(v) for n, v in jscope.vars.items()}
    scope = tfluid.Scope()
    scope.load_numpy(init, tfluid.CPUPlace())
    exe = tfluid.Executor(tfluid.CPUPlace())
    got = [float(np.asarray(exe.run(tmain, feed=f, fetch_list=[tloss],
                                    scope=scope)[0])[0]) for f in feeds]
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert got[-1] != got[0]
    mine = scope.to_numpy(sorted(final))
    for n, w in final.items():
        scale = max(float(np.abs(w).max()), 1.0)
        np.testing.assert_allclose(mine[n], w, rtol=0, atol=TOL * scale,
                                   err_msg=n)
