"""The initializers the port's fluid/initializer.py gained (TruncatedNormal,
MSRA, Bilinear, NumpyArrayInitializer) and the init_on_cpu flag, against
the JAX package's startup programs, on the CPU:

  * the startup programs are the JAX package's op for op (the same ops,
    attrs and values), _fan_in_out is the JAX one's on every rank;
  * the deterministic initializers run to the JAX startup's values bit for
    bit, and a depthwise conv2d_transpose with a Bilinear filter upsamples
    as the JAX one does within 1e-5;
  * the random ones by their law: TruncatedNormal inside +-2 std with the
    truncated law's std (0.8796 std) within 2%, MSRA uniform inside its
    limit with std limit / sqrt(3) within 2%, MSRA normal with its std
    within 2%;
  * init_on_cpu sets the flag force_init_on_cpu reads, nests and restores,
    and changes nothing in the program, in either package.
"""
import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import framework as jframework
from paddle_tpu.fluid import initializer as jinit
from paddle_tpu.fluid import unique_name as junique
from paddle_tpu.fluid.executor import Scope as JScope

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import framework as tframework
from paddle_tpu_torch.fluid import initializer as tinit
from paddle_tpu_torch.fluid import unique_name as tunique

from test_torch_detection import _close
from test_torch_training import _normalized

JAX = (jfluid, jframework, junique)
PORT = (tfluid, tframework, tunique)
VALUES = np.arange(24, dtype='float32').reshape(4, 6) * 0.37 - 3.1
IDS = np.array([[3, -7, 11], [0, 2**30, 5]], "int64")   # int32 in JAX


def _net(fluid):
    layers, init = fluid.layers, fluid.initializer
    x = layers.data(name='x', shape=[3, 5, 5], dtype='float32')
    h = layers.data(name='h', shape=[6], dtype='float32')
    up = layers.conv2d_transpose(
        x, num_filters=3, filter_size=4, stride=2, padding=1, groups=3,
        param_attr=fluid.ParamAttr(name='up_w', initializer=init.Bilinear()),
        bias_attr=False)
    big = layers.fc(h, size=300, param_attr=fluid.ParamAttr(
        name='tn_w', initializer=init.TruncatedNormal(loc=0.5, scale=2.0)),
        bias_attr=False)
    conv = layers.conv2d(x, num_filters=400, filter_size=5, param_attr=(
        fluid.ParamAttr(name='msra_u', initializer=init.MSRA())),
        bias_attr=False)
    conv2 = layers.conv2d(x, num_filters=400, filter_size=5, param_attr=(
        fluid.ParamAttr(name='msra_n', initializer=init.MSRA(
            uniform=False))), bias_attr=False)
    fc2 = layers.fc(h, size=4, param_attr=fluid.ParamAttr(
        name='msra_fan', initializer=init.MSRAInitializer(fan_in=9)),
        bias_attr=False)
    arr = layers.fc(h, size=4, param_attr=fluid.ParamAttr(
        name='np_w', initializer=init.NumpyArrayInitializer(VALUES.T)),
        bias_attr=False)
    # Xavier reads the same _fan_in_out: its limits are the JAX startup's
    layers.conv2d(x, num_filters=7, filter_size=3, param_attr=(
        fluid.ParamAttr(name='xavier_w', initializer=init.Xavier())),
        bias_attr=False)
    helper = fluid.layer_helper.LayerHelper('ids')
    ids = helper.create_parameter(
        attr=fluid.ParamAttr(name='ids', initializer=(
            init.NumpyArrayInitializer(IDS))), shape=[2, 3], dtype='int64')
    return [up, big, conv, conv2, fc2, arr, ids]


def _build(pkg, on_cpu=False):
    fluid, framework, unique_name = pkg
    main, startup = framework.Program(), framework.Program()
    with unique_name.guard(), framework.program_guard(main, startup):
        if on_cpu:
            with fluid.initializer.init_on_cpu():
                fetch = _net(fluid)
        else:
            fetch = _net(fluid)
    return main, startup, fetch


def _startups():
    jmain, jstart, jfetch = _build(JAX)
    tmain, tstart, tfetch = _build(PORT)
    jscope = JScope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jstart, scope=jscope)
    tscope = tfluid.Scope()
    texe = tfluid.Executor(tfluid.CPUPlace())
    texe.run(tstart, scope=tscope)
    return (jmain, jstart, jfetch, jexe, jscope), \
        (tmain, tstart, tfetch, texe, tscope)


def test_startup_programs_are_the_jax_ones():
    (jmain, jstart, *_), (tmain, tstart, *_) = _startups()
    assert _normalized(tstart) == _normalized(jstart)
    assert _normalized(tmain) == _normalized(jmain)
    types = [op.type for op in tstart.global_block().ops]
    assert types.count('assign_value') == 3
    assert 'truncated_gaussian_random' in types


@pytest.mark.parametrize('shape', [[], [7], [3, 4], [6, 3, 5, 5],
                                   [2, 3, 4, 5, 6]])
def test_fan_in_out_is_the_jax_ones(shape):
    class V(object):
        pass

    v = V()
    v.shape = shape
    assert tinit._fan_in_out(v) == jinit._fan_in_out(v)


def test_deterministic_initializers_bit_for_bit():
    (*_, jscope), (*_, tscope) = _startups()
    for n in ('up_w', 'np_w', 'ids'):
        got = tscope.to_numpy([n])[n]
        want = np.asarray(jscope.vars[n])
        assert got.shape == want.shape, n
        np.testing.assert_array_equal(got, want, err_msg=n)
    np.testing.assert_array_equal(tscope.to_numpy(['np_w'])['np_w'],
                                  VALUES.T)
    ids = tscope.to_numpy(['ids'])['ids']
    assert ids.dtype == np.int64
    np.testing.assert_array_equal(ids, IDS)


def test_bilinear_filter_upsamples_as_the_jax_one():
    (jmain, _, jfetch, jexe, jscope), (tmain, _, tfetch, texe, tscope) = \
        _startups()
    rng = np.random.RandomState(30)
    feed = {'x': rng.randn(2, 3, 5, 5).astype('float32'),
            'h': rng.randn(2, 6).astype('float32')}
    want = jexe.run(jmain, feed=feed, fetch_list=[jfetch[0]], scope=jscope)
    got = texe.run(tmain, feed=feed, fetch_list=[tfetch[0]], scope=tscope)
    assert np.asarray(got[0]).shape == (2, 3, 10, 10)
    _close(np.asarray(got[0]), np.asarray(want[0]), 'bilinear upsample')
    # a constant map upsamples to the constant inside the border
    feed['x'] = np.ones_like(feed['x'])
    ones = texe.run(tmain, feed=feed, fetch_list=[tfetch[0]], scope=tscope)
    np.testing.assert_allclose(np.asarray(ones[0])[:, :, 1:-1, 1:-1], 1.0,
                               rtol=0, atol=1e-6)


def _std_within(values, want, rel=0.02):
    got = float(np.std(values.astype('float64')))
    assert abs(got - want) <= rel * want, (got, want)


def test_truncated_normal_by_its_law():
    (*_, jscope), (*_, tscope) = _startups()
    for w in (tscope.to_numpy(['tn_w'])['tn_w'], np.asarray(jscope.vars[
            'tn_w'])):
        assert w.shape == (6, 300)
    w = tscope.to_numpy(['tn_w'])['tn_w']
    assert (w >= 0.5 - 4.0).all() and (w <= 0.5 + 4.0).all()
    assert abs(float(w.mean()) - 0.5) < 0.2
    _std_within(w, 0.8796 * 2.0, rel=0.1)   # 1,800 draws
    # a large draw from the rule the initializer appends, by its law
    big = _startup_draw(tinit.TruncatedNormal(loc=0.0, scale=3.0),
                        [400, 500])
    assert np.abs(big).max() <= 6.0 + 1e-5
    _std_within(big, 0.8796 * 3.0)


def _startup_draw(initializer, shape):
    main, startup = tframework.Program(), tframework.Program()
    with tunique.guard(), tframework.program_guard(main, startup):
        helper = tfluid.layer_helper.LayerHelper('draw')
        helper.create_parameter(attr=tfluid.ParamAttr(
            name='p', initializer=initializer), shape=shape,
            dtype='float32')
    scope = tfluid.Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(startup, scope=scope)
    return scope.to_numpy(['p'])['p']


def test_msra_by_its_law():
    (*_, jscope), (*_, tscope) = _startups()
    fan_in = 3 * 5 * 5
    limit = np.sqrt(6.0 / fan_in)
    u = tscope.to_numpy(['msra_u'])['msra_u']
    assert u.shape == np.asarray(jscope.vars['msra_u']).shape
    assert np.abs(u).max() <= limit
    assert np.abs(u).max() > 0.99 * limit
    _std_within(u, limit / np.sqrt(3.0))
    _std_within(tscope.to_numpy(['msra_n'])['msra_n'],
                np.sqrt(2.0 / fan_in))
    assert np.abs(tscope.to_numpy(['msra_fan'])['msra_fan']).max() <= \
        np.sqrt(6.0 / 9)


def test_init_on_cpu_is_an_inert_flag_in_both_packages():
    for init in (jinit, tinit):
        assert init.force_init_on_cpu() is False
        with init.init_on_cpu():
            assert init.force_init_on_cpu() is True
            with init.init_on_cpu():
                assert init.force_init_on_cpu() is True
            assert init.force_init_on_cpu() is True
        assert init.force_init_on_cpu() is False
        with pytest.raises(KeyError):
            with init.init_on_cpu():
                raise KeyError('inside')
        assert init.force_init_on_cpu() is False
    plain = _build(PORT)
    flagged = _build(PORT, on_cpu=True)
    for a, b in zip(plain[:2], flagged[:2]):
        assert _normalized(a) == _normalized(b)


def test_initializer_names_cover_the_jax_module():
    assert set(jinit.__all__) <= set(tinit.__all__)
    for name in jinit.__all__:
        assert hasattr(tinit, name), name
    assert tinit.MSRA is tinit.MSRAInitializer
    assert tinit.Bilinear is tinit.BilinearInitializer
    assert tinit.TruncatedNormal is tinit.TruncatedNormalInitializer
