"""The dense training surface's op rules of the PyTorch port (the
activations, comparisons, logicals, reductions and clip_by_norm, maxout,
cos_sim, l2_normalize of ops_impl/math_ops.py; the tensor rules of
ops_impl/tensor_ops.py) against the JAX package's rule for the same op
type, on the same seeded numpy inputs: forward, and the gradient (VJP of
a seeded cotangent, jax.vjp against torch.autograd) where the op is
differentiable.

Tolerances: TOL (1e-6, rtol and atol) where both frameworks compute the
same IEEE operations; TRANS_TOL (rtol 1e-5, atol 1e-6) where a
transcendental (tanh, exp, log, log1p, logaddexp, sigmoid, sin, cos)
enters, whose XLA CPU approximation and ATen's differ by a few ulps.
Inputs include the ties where a max, min, clip or |x| decides the
gradient (0, the clip bounds, equal maxima): there the port takes JAX's
gradients (0.5 / 0.5 at a max or min tie, 1 at |0|). The three repaired
faults (relu and clip at ties, sigmoid cross entropy at logit 0) are
named tests. Random rules are held to their distribution, not to JAX's
bits. Integer outputs (arg_max's ids) compare by value: the JAX package
emits int32 with x64 off, the port int64.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu.fluid  # noqa: F401  (registers the JAX rules)
from paddle_tpu.fluid import lowering as jlow
import paddle_tpu_torch.fluid  # noqa: F401  (registers the port's rules)
from paddle_tpu_torch.fluid import lowering as tlow

TOL = 1e-6
TRANS_TOL = (1e-5, 1e-6)   # rtol, atol

# tie points of the clips, maxima and |x| below, and a spread of values
TIES = np.array([0.0, 0.5, -0.5, 1.0, -1.0, 2.0, -2.0, 2.5, -2.5, 6.0,
                 0.0, 3.0], 'float32')


def _x(seed, lo=-5.0, hi=5.0):
    r = np.random.RandomState(seed)
    x = r.uniform(lo, hi, (4, 12)).astype('float32')
    x[0] = np.clip(TIES, lo, hi)
    return x


def _ctx_jax():
    return jlow.Ctx(jax.random.key(0), is_test=False, platform='cpu')


def _ctx_port(seed=0):
    gen = torch.Generator()
    gen.manual_seed(seed)
    return tlow.Ctx(torch.device('cpu'), gen)


def _forward(op_type, ins, attrs):
    jouts = jlow.get_rule(op_type)(
        {s: [jnp.asarray(a) for a in vs] for s, vs in ins.items()},
        attrs, _ctx_jax())
    touts = tlow.get_rule(op_type)(
        {s: [torch.from_numpy(np.array(a)) for a in vs]
         for s, vs in ins.items()}, attrs, _ctx_port())
    return jouts, touts


def _close(t, j, tol, what):
    rtol, atol = (tol, tol) if np.isscalar(tol) else tol
    t, j = np.asarray(t), np.asarray(j)
    assert t.shape == j.shape, (what, t.shape, j.shape)
    np.testing.assert_allclose(t, j, rtol=rtol, atol=atol, err_msg=what)


def _check(op_type, ins, attrs, slots=('Out',), tol=TOL):
    jouts, touts = _forward(op_type, ins, attrs)
    for slot in slots:
        j, t = jouts[slot], touts[slot]
        if isinstance(j, (list, tuple)):
            assert len(j) == len(t)
            for k, (jj, tt) in enumerate(zip(j, t)):
                _close(tt.numpy(), jj, tol, '%s.%s[%d]' % (op_type, slot, k))
        else:
            _close(t.numpy(), j, tol, '%s.%s' % (op_type, slot))
    return jouts, touts


def _vjps(op_type, ins, attrs, wrt, slot='Out', seed=7):
    """The VJP of out[slot] at a seeded cotangent with respect to the
    float inputs named in `wrt` ({slot: index}), in both packages."""
    keys = list(wrt)

    def jf(*args):
        jins = {s: [jnp.asarray(a) for a in vs] for s, vs in ins.items()}
        for k, a in zip(keys, args):
            jins[k][wrt[k]] = a
        out = jlow.get_rule(op_type)(jins, attrs, _ctx_jax())[slot]
        return out[0] if isinstance(out, (list, tuple)) else out

    primals = [jnp.asarray(ins[k][wrt[k]]) for k in keys]
    out, pull = jax.vjp(jf, *primals)
    cot = np.asarray(np.random.RandomState(seed).randn(*out.shape),
                     dtype=out.dtype)
    jgrads = pull(jnp.asarray(cot))

    tins = {s: [torch.from_numpy(np.array(a)) for a in vs]
            for s, vs in ins.items()}
    leaves = []
    for k in keys:
        t = tins[k][wrt[k]].clone().requires_grad_(True)
        tins[k][wrt[k]] = t
        leaves.append(t)
    tout = tlow.get_rule(op_type)(tins, attrs, _ctx_port())[slot]
    tout = tout[0] if isinstance(tout, (list, tuple)) else tout
    tgrads = torch.autograd.grad(tout, leaves, torch.from_numpy(cot))
    return [np.asarray(g) for g in jgrads], [g.numpy() for g in tgrads]


def _check_grad(op_type, ins, attrs, wrt, slot='Out', tol=TOL):
    jg, tg = _vjps(op_type, ins, attrs, wrt, slot)
    for k, j, t in zip(wrt, jg, tg):
        _close(t, j, tol, '%s d%s' % (op_type, k))


# -- the three repaired faults -----------------------------------------------

def test_relu_gradient_at_zero_splits_as_jnp_maximum():
    x = np.array([0.0, 1.0, -1.0], 'float32')
    jg, tg = _vjps('relu', {'X': [x]}, {}, {'X': 0})
    np.testing.assert_array_equal(tg[0], jg[0])
    # JAX's own gradient at the smallest input: [0.5, 1, 0]
    g = np.asarray(jax.grad(lambda v: jnp.sum(
        jlow.get_rule('relu')({'X': [v]}, {}, _ctx_jax())['Out']))(x))
    t = torch.from_numpy(x).requires_grad_(True)
    tlow.get_rule('relu')({'X': [t]}, {}, _ctx_port())['Out'].sum().backward()
    np.testing.assert_array_equal(g, [0.5, 1.0, 0.0])
    np.testing.assert_array_equal(t.grad.numpy(), g)


def test_clip_gradient_at_its_bounds_splits_as_jnp_clip():
    x = np.array([-1.0, 1.0, 0.0], 'float32')
    attrs = {'min': -1.0, 'max': 1.0}
    t = torch.from_numpy(x).requires_grad_(True)
    tlow.get_rule('clip')({'X': [t]}, attrs, _ctx_port())['Out'] \
        .sum().backward()
    g = np.asarray(jax.grad(lambda v: jnp.sum(
        jlow.get_rule('clip')({'X': [v]}, attrs, _ctx_jax())['Out']))(x))
    np.testing.assert_array_equal(g, [0.5, 0.5, 1.0])
    np.testing.assert_array_equal(t.grad.numpy(), g)


def test_sigmoid_cross_entropy_gradient_at_logit_zero_is_minus_label():
    x = np.zeros(2, 'float32')
    label = np.array([0.0, 1.0], 'float32')
    op = 'sigmoid_cross_entropy_with_logits'
    t = torch.from_numpy(x).requires_grad_(True)
    tlow.get_rule(op)({'X': [t], 'Label': [torch.from_numpy(label)]}, {},
                      _ctx_port())['Out'].sum().backward()
    g = np.asarray(jax.grad(lambda v: jnp.sum(jlow.get_rule(op)(
        {'X': [v], 'Label': [jnp.asarray(label)]}, {},
        _ctx_jax())['Out']))(x))
    np.testing.assert_array_equal(g, [0.0, -1.0])
    np.testing.assert_array_equal(t.grad.numpy(), g)


# -- activations ---------------------------------------------------------------

# (op, attrs, input range, transcendental?)
UNARY = [
    ('relu', {}, (-5, 5), False),
    ('clip', {'min': -1.0, 'max': 2.0}, (-5, 5), False),
    ('sign', {}, (-5, 5), False),
    ('logsigmoid', {}, (-5, 5), True),
    ('exp', {}, (-5, 5), True),
    ('tanh', {}, (-5, 5), True),
    ('tanh_shrink', {}, (-5, 5), True),
    ('softshrink', {'lambda': 0.5}, (-5, 5), False),
    ('softshrink', {}, (-5, 5), False),
    ('abs', {}, (-5, 5), False),
    ('ceil', {}, (-5, 5), False),
    ('floor', {}, (-5, 5), False),
    ('cos', {}, (-5, 5), True),
    ('sin', {}, (-5, 5), True),
    ('round', {}, (-5, 5), False),
    ('reciprocal', {}, (0.5, 5), False),
    ('softplus', {}, (-5, 5), True),
    ('softsign', {}, (-5, 5), False),
    ('brelu', {'t_min': 0.5, 't_max': 2.0}, (-5, 5), False),
    ('brelu', {}, (-5, 30), False),
    ('leaky_relu', {'alpha': 0.1}, (-5, 5), False),
    ('leaky_relu', {}, (-5, 5), False),
    ('soft_relu', {'threshold': 2.0}, (-5, 5), True),
    ('soft_relu', {}, (-5, 5), True),
    ('elu', {'alpha': 1.5}, (-5, 5), True),
    ('elu', {}, (-5, 5), True),
    ('relu6', {'threshold': 1.0}, (-5, 5), False),
    ('relu6', {}, (-5, 8), False),
    ('pow', {'factor': 3.0}, (-5, 5), False),
    ('pow', {'factor': 0.5}, (0.5, 5), True),
    ('stanh', {}, (-5, 5), True),
    ('stanh', {'scale_a': 0.5, 'scale_b': 2.0}, (-5, 5), True),
    ('hard_sigmoid', {}, (-5, 5), False),
    ('hard_sigmoid', {'slope': 0.5, 'offset': 0.0}, (-5, 5), False),
    ('swish', {'beta': 1.5}, (-5, 5), True),
    ('swish', {}, (-5, 5), True),
    ('hard_shrink', {'threshold': 0.5}, (-5, 5), False),
    ('hard_shrink', {}, (-5, 5), False),
    ('thresholded_relu', {'threshold': 0.5}, (-5, 5), False),
    ('thresholded_relu', {}, (-5, 5), False),
    ('log', {}, (0.5, 5), True),
]


@pytest.mark.parametrize('op_type,attrs,lo_hi,trans', UNARY,
                         ids=['%s-%d' % (u[0], i)
                              for i, u in enumerate(UNARY)])
def test_activation_forward_and_gradient(op_type, attrs, lo_hi, trans):
    tol = TRANS_TOL if trans else TOL
    x = _x(hash(op_type) % 1000, *lo_hi)
    _check(op_type, {'X': [x]}, attrs, tol=tol)
    _check_grad(op_type, {'X': [x]}, attrs, {'X': 0}, tol=tol)


def test_elu_gradient_past_exp_overflow_is_finite_in_the_port():
    """jnp.where's gradient is NaN where exp(x) overflows (x > 88) in the
    untaken branch; the port's elu takes exp of min(x, 0) there and keeps
    the gradient of 1 (ROADMAP.md Queue C, a reference behaviour not
    copied)."""
    x = np.array([100.0, 1.0, -1.0], 'float32')
    jg, tg = _vjps('elu', {'X': [x]}, {}, {'X': 0})
    assert np.isnan(jg[0][0])
    cot = np.random.RandomState(7).randn(3).astype('float32')
    np.testing.assert_allclose(tg[0], cot * [1.0, 1.0, np.exp(-1.0)],
                               rtol=1e-6)


def test_logical_not_and_binary_logicals_return_bool():
    r = np.random.RandomState(3)
    a, b = r.rand(4, 5) > 0.5, r.rand(4, 5) > 0.5
    _, t = _check('logical_not', {'X': [a]}, {})
    assert t['Out'].dtype == torch.bool
    for op in ('logical_and', 'logical_or', 'logical_xor'):
        _, t = _check(op, {'X': [a], 'Y': [b]}, {})
        assert t['Out'].dtype == torch.bool


@pytest.mark.parametrize('op_type', ['less_than', 'less_equal',
                                     'greater_than', 'greater_equal',
                                     'equal', 'not_equal'])
@pytest.mark.parametrize('yshape,axis', [((3, 4), -1), ((4,), -1),
                                         ((3,), 0), ((1,), -1)])
def test_comparison_with_the_fluid_broadcast(op_type, yshape, axis):
    r = np.random.RandomState(4)
    x = r.randint(-2, 3, (3, 4)).astype('float32')
    y = r.randint(-2, 3, yshape).astype('float32')
    j, t = _check(op_type, {'X': [x], 'Y': [y]}, {'axis': axis})
    assert t['Out'].dtype == torch.bool
    assert np.asarray(j['Out']).dtype == np.bool_


# -- reductions and the rest of math_ops -----------------------------------

REDUCE_ATTRS = [
    {'dim': [0], 'keep_dim': False, 'reduce_all': True},
    {'dim': [1], 'keep_dim': True, 'reduce_all': False},
    {'dim': [0, 2], 'keep_dim': False, 'reduce_all': False},
    {'dim': [-1], 'keep_dim': False, 'reduce_all': False},
]


@pytest.mark.parametrize('op_type', ['reduce_mean', 'reduce_max',
                                     'reduce_min', 'reduce_prod'])
@pytest.mark.parametrize('attrs', REDUCE_ATTRS)
def test_reduction_forward_and_gradient(op_type, attrs):
    r = np.random.RandomState(5)
    if op_type == 'reduce_prod':
        x = r.uniform(0.5, 1.5, (3, 4, 5)).astype('float32')
        x[1, 2, 3] = 0.0                  # a zero factor
    else:
        # ties of the max and the min along every axis
        x = r.randint(-3, 4, (3, 4, 5)).astype('float32')
    _check(op_type, {'X': [x]}, attrs)
    _check_grad(op_type, {'X': [x]}, attrs, {'X': 0})


def test_reduce_mean_of_integers_is_float32():
    x = np.arange(12, dtype='int32').reshape(3, 4)
    _, t = _check('reduce_mean', {'X': [x]},
                  {'dim': [1], 'keep_dim': False, 'reduce_all': False})
    assert t['Out'].dtype == torch.float32


@pytest.mark.parametrize('max_norm', [0.5, 1e3])
def test_clip_by_norm(max_norm):
    x = np.random.RandomState(6).randn(4, 6).astype('float32')
    _check('clip_by_norm', {'X': [x]}, {'max_norm': max_norm})
    _check_grad('clip_by_norm', {'X': [x]}, {'max_norm': max_norm}, {'X': 0})


def test_maxout_with_ties():
    x = np.random.RandomState(8).randint(-2, 3, (2, 6, 3, 3)) \
        .astype('float32')
    _check('maxout', {'X': [x]}, {'groups': 3})
    _check_grad('maxout', {'X': [x]}, {'groups': 3}, {'X': 0})


@pytest.mark.parametrize('y_rows', [4, 1])
def test_cos_sim(y_rows):
    r = np.random.RandomState(9)
    ins = {'X': [r.randn(4, 6).astype('float32')],
           'Y': [r.randn(y_rows, 6).astype('float32')]}
    _check('cos_sim', ins, {}, slots=('Out', 'XNorm', 'YNorm'))
    _check_grad('cos_sim', ins, {}, {'X': 0, 'Y': 0}, tol=TRANS_TOL)


@pytest.mark.parametrize('axis', [1, -1, 0])
def test_l2_normalize(axis):
    x = np.random.RandomState(10).randn(4, 5, 6).astype('float32')
    x[0, 0] = 0.0                          # a zero row: the epsilon floor
    attrs = {'axis': axis, 'epsilon': 1e-12}
    _check('l2_normalize', {'X': [x]}, attrs, slots=('Out', 'Norm'))
    _check_grad('l2_normalize', {'X': [x]}, attrs, {'X': 0}, tol=TRANS_TOL)


# -- tensor_ops ----------------------------------------------------------------

def _f32(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype('float32')


def test_fill_constant_batch_size_like():
    ref = _f32(0, 7, 3)
    _check('fill_constant_batch_size_like', {'Input': [ref]},
           {'shape': [-1, 5], 'value': 0.5, 'dtype': 'float32',
            'input_dim_idx': 0, 'output_dim_idx': 0})
    _check('fill_constant_batch_size_like', {'Input': [ref]},
           {'shape': [2, -1, 4], 'value': 3.0, 'dtype': 'int64',
            'input_dim_idx': 1, 'output_dim_idx': 1})


def test_shape_is_int32():
    j, t = _check('shape', {'Input': [_f32(0, 2, 3, 5)]}, {})
    assert t['Out'].dtype == torch.int32


# (op, a maker of its inputs, attrs, output slots, float inputs to
# differentiate)
SHAPE_OPS = [
    ('squeeze', lambda: {'X': [_f32(1, 2, 1, 3, 1)]}, {'axes': [1]},
     ('Out',), {'X': 0}),
    ('squeeze', lambda: {'X': [_f32(1, 2, 1, 3, 1)]}, {}, ('Out',),
     {'X': 0}),
    ('unsqueeze', lambda: {'X': [_f32(2, 2, 3)]}, {'axes': [0, 3]},
     ('Out',), {'X': 0}),
    ('split', lambda: {'X': [_f32(3, 4, 6)]}, {'axis': -1, 'num': 3},
     ('Out',), {'X': 0}),
    ('split', lambda: {'X': [_f32(3, 4, 6)]},
     {'axis': 1, 'num': 0, 'sections': [1, 3]}, ('Out',), {'X': 0}),
    ('stack', lambda: {'X': [_f32(4, 2, 3), _f32(5, 2, 3)]}, {'axis': 1},
     ('Y',), {'X': 1}),
    ('flatten', lambda: {'X': [_f32(6, 2, 3, 4)]}, {'axis': 2}, ('Out',),
     {'X': 0}),
    ('flatten', lambda: {'X': [_f32(6, 2, 3, 4)]}, {'axis': 0}, ('Out',),
     {'X': 0}),
    ('pad', lambda: {'X': [_f32(7, 2, 3)]},
     {'paddings': [1, 0, 2, 3], 'pad_value': 0.5}, ('Out',), {'X': 0}),
    ('crop', lambda: {'X': [_f32(8, 2, 3)]},
     {'offsets': [1, 2], 'shape': [1, 2]}, ('Out',), {'X': 0}),
    ('crop', lambda: {'X': [_f32(8, 4, 5)], 'Y': [_f32(9, 2, 3)]},
     {'offsets': [1, 1]}, ('Out',), {'X': 0}),
    ('crop', lambda: {'X': [_f32(8, 4, 5)]},
     {'offsets': [1, 2], 'shape': [-1, 2]}, ('Out',), {'X': 0}),
    ('slice', lambda: {'Input': [_f32(10, 4, 5, 6)]},
     {'axes': [0, 2], 'starts': [1, -4], 'ends': [3, 100]}, ('Out',),
     {'Input': 0}),
    ('expand', lambda: {'X': [_f32(11, 2, 3)]}, {'expand_times': [2, 3]},
     ('Out',), {'X': 0}),
    ('reverse', lambda: {'X': [_f32(12, 3, 4)]}, {'axis': [0, 1]},
     ('Out',), {'X': 0}),
    ('reverse', lambda: {'X': [_f32(12, 3, 4)]}, {'axis': 1}, ('Out',),
     {'X': 0}),
]


@pytest.mark.parametrize('op_type,make,attrs,slots,wrt', SHAPE_OPS,
                         ids=['%s-%d' % (o[0], i)
                              for i, o in enumerate(SHAPE_OPS)])
def test_shape_op_forward_and_gradient(op_type, make, attrs, slots, wrt):
    ins = make()
    _check(op_type, ins, attrs, slots=slots)
    _check_grad(op_type, ins, attrs, wrt, slot=slots[0])


def test_crop_clamps_its_start_as_dynamic_slice():
    x = np.arange(6, dtype='float32').reshape(2, 3)
    _, t = _check('crop', {'X': [x]}, {'offsets': [1, 2], 'shape': [1, 2]})
    np.testing.assert_array_equal(t['Out'].numpy(), [[4.0, 5.0]])


@pytest.mark.parametrize('index', [[2, 0, 3, 2], [5, -1, -5, 1, 1]])
def test_gather(index):
    x = _f32(13, 4, 3)
    ins = {'X': [x], 'Index': [np.array(index, 'int64')]}
    _check('gather', ins, {})
    _check_grad('gather', ins, {}, {'X': 0})


def test_gather_out_of_range_fills_as_jnp_take():
    ins = {'X': [np.arange(4, dtype='int32')],
           'Index': [np.array([5, -1, -5], 'int64')]}
    _, t = _check('gather', ins, {})
    imin = np.iinfo(np.int32).min
    np.testing.assert_array_equal(t['Out'].numpy(), [imin, 3, imin])
    _, t = _check('gather', {'X': [np.arange(4, dtype='float32')],
                             'Index': ins['Index']}, {})
    assert np.isnan(t['Out'].numpy()[[0, 2]]).all()


def test_scatter_wraps_drops_and_keeps_the_last_duplicate():
    ins = {'X': [np.zeros(3, 'float32')],
           'Ids': [np.array([1, 1, 5, -1], 'int64')],
           'Updates': [np.array([1.0, 2.0, 3.0, 4.0], 'float32')]}
    _, t = _check('scatter', ins, {})
    np.testing.assert_array_equal(t['Out'].numpy(), [0.0, 2.0, 4.0])
    _check_grad('scatter', ins, {}, {'X': 0, 'Updates': 0})


def test_scatter_rows():
    ins = {'X': [_f32(14, 6, 3)], 'Ids': [np.array([4, 0, 4, 2], 'int64')],
           'Updates': [_f32(15, 4, 3)]}
    _check('scatter', ins, {})
    _check_grad('scatter', ins, {}, {'X': 0, 'Updates': 0})


@pytest.mark.parametrize('op_type', ['arg_max', 'arg_min'])
@pytest.mark.parametrize('axis', [0, 1])
def test_arg_max_min_ties_and_nan(op_type, axis):
    x = np.random.RandomState(16).randint(-2, 3, (5, 6)).astype('float32')
    _check(op_type, {'X': [x]}, {'axis': axis})
    x[2, 3] = np.nan
    x[4, 1] = np.nan
    j, t = _check(op_type, {'X': [x]}, {'axis': axis})
    assert t['Out'].dtype == torch.int64


@pytest.mark.parametrize('axis', [-1, 0])
def test_argsort_is_stable_nan_last_and_signed_zeros_equal(axis):
    x = np.random.RandomState(17).randint(-2, 3, (5, 6)).astype('float32')
    x[0, :4] = [0.0, -0.0, 0.0, -0.0]
    x[1, 2] = np.nan
    x[3, 0] = np.nan
    _check('argsort', {'X': [x]}, {'axis': axis}, slots=('Out', 'Indices'))


def test_argsort_gradient():
    ins = {'X': [_f32(18, 4, 5)]}
    _check_grad('argsort', ins, {'axis': -1}, {'X': 0})


@pytest.mark.parametrize('ids', [[0, 2, 1, 1], [-1, 5, 0, 2]])
def test_multiplex_wraps_and_clamps(ids):
    ins = {'X': [_f32(19, 4, 3), _f32(20, 4, 3), _f32(21, 4, 3)],
           'Ids': [np.array(ids, 'int64').reshape(4, 1)]}
    _check('multiplex', ins, {})
    _check_grad('multiplex', ins, {}, {'X': 1})


def _port_rule(op_type, ins, attrs, seed):
    return tlow.get_rule(op_type)(
        {s: [torch.from_numpy(np.array(a)) for a in vs]
         for s, vs in ins.items()}, attrs, _ctx_port(seed))


def test_random_crop_is_a_window_with_uniform_starts():
    x = np.arange(2 * 5 * 6, dtype='float32').reshape(2, 5, 6)
    starts = set()
    for seed in range(200):
        out = _port_rule('random_crop', {'X': [x]}, {'shape': [3, 2]},
                         seed)['Out'].numpy()
        assert out.shape == (2, 3, 2)
        r0, c0 = divmod(int(out[0, 0, 0]), 6)
        np.testing.assert_array_equal(out, x[:, r0:r0 + 3, c0:c0 + 2])
        starts.add((r0, c0))
    # every start of the 3 x 5 possible ones drawn within 200 draws
    assert starts == {(r, c) for r in range(3) for c in range(5)}
    j, _ = _forward('random_crop', {'X': [x]}, {'shape': [3, 2]})
    assert np.asarray(j['Out']).shape == (2, 3, 2)


@pytest.mark.parametrize('op_type,attrs,mean,std,lo,hi', [
    ('uniform_random_batch_size_like',
     {'min': -1.0, 'max': 3.0}, 1.0, 4 / 12 ** 0.5, -1.0, 3.0),
    ('gaussian_random_batch_size_like',
     {'mean': 0.5, 'std': 2.0}, 0.5, 2.0, -np.inf, np.inf),
    ('truncated_gaussian_random',
     {'mean': 0.5, 'std': 2.0}, 0.5, 2.0 * 0.87962566, 0.5 - 4.0,
     0.5 + 4.0)])
def test_random_rules_hold_their_distribution(op_type, attrs, mean, std, lo,
                                              hi):
    """Shape, dtype, bounds, mean and std (the truncated normal's std is
    0.8796 sigma at +-2 sigma) in both packages; a re-seed draws the same
    numbers in the port, another seed others."""
    if op_type == 'truncated_gaussian_random':
        ins = {}
        attrs = dict(attrs, shape=[300, 200], dtype='float32', seed=0)
    else:
        ins = {'Input': [np.zeros((300, 3), 'float32')]}
        attrs = dict(attrs, shape=[-1, 200], dtype='float32', seed=0,
                     input_dim_idx=0, output_dim_idx=0)
    jouts, _ = _forward(op_type, ins, attrs)
    outs = [np.asarray(jouts['Out'])] + [
        _port_rule(op_type, ins, attrs, s)['Out'].numpy() for s in (1, 1, 2)]
    for out in outs:
        assert out.shape == (300, 200) and out.dtype == np.float32
        assert out.min() >= lo and out.max() <= hi
        assert abs(out.mean() - mean) < 0.02 * std
        assert abs(out.std() - std) < 0.02 * std
    np.testing.assert_array_equal(outs[1], outs[2])
    assert not np.array_equal(outs[1], outs[3])
