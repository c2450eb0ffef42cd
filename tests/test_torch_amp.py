"""AMP in the PyTorch port (fluid/amp.py, lowering.amp_cast and its rule
sites, bf16 feeds, scopes and fetches, the bf16 attention, the Queue C
gather rule) against the JAX package, on the CPU, at small sizes, with
numpy inputs from a seed:

  * each amp_cast rule (mul, matmul, conv2d, flash_attention) called
    directly in both packages, AMP on and off, fp32 and bf16 inputs: the
    same output dtype, values within 1e-5 of max |out| for an fp32 result
    (both take the exact product of the bf16-rounded operands in fp32, in
    other orders) and within two bf16 ulps of max |out| for a bf16 result
    (one rounding of nearly the same fp32 value);
  * the card's AMP product (_Bf16Product) with its GEMM emulated: its
    backward against the exact form, the cotangent kept to 2^-17 by its
    bf16 hi + lo split (at most 1% of the gradient's elements, and one
    bf16 ulp, apart);
  * the plain bf16 attention, forward and backward (lse cotangent
    included), against reference_attention and jax.grad of it on bf16
    inputs: two bf16 ulps of max |x|, lse 1e-5;
  * the rules that see bf16 activations in a bf16 tower: two bf16 ulps of
    max |x|, where the port rounds once and the JAX rule after each of
    its bf16 operations (batch_norm's Y, softmax, pool, the elementwise
    ops; see the test); batch_norm's bf16 Y rounded once, bf16 or fp32
    Scale and Bias;
  * a narrow 2+2-layer Transformer under decorate_program, weights carried
    across by Scope.load_numpy: each step-1 gradient within the distance
    AMP itself puts between JAX's bf16 and fp32 gradients (relative L2),
    and 3 Adam steps' losses within 1e-3 relative (an fp32 sum taken in
    another order can round an intermediate bf16 value to its neighbour,
    2^-8 relative, and the flip travels on);
  * resnet_cifar10 at depth 8 with a bf16 feed, NCHW and NHWC, 3 Momentum
    steps' losses within 1e-2 relative (a bf16 tower from the feed on);
  * the port's AMP trajectory against its fp32 one within the JAX
    test_amp.py bound (rtol 0.1, atol 1e-2), the fp32 fetch dtype kept;
  * the amp flag in the step's key, Program.clone carrying it;
  * bf16 top_k over +-0, NaN and ties against lax.top_k, exactly;
  * Queue C: out-of-range labels and ids give JAX's values (NaN, or the
    wrapped index);
  * bf16 load_numpy / to_numpy, feeds and fetches, and the DataFeeder.
"""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import ml_dtypes

import paddle_tpu.fluid as jfluid
from paddle_tpu import ops as jops
from paddle_tpu.fluid import framework as jframework
from paddle_tpu.fluid import lowering as jlowering
from paddle_tpu.fluid import unique_name as junique
from paddle_tpu.fluid.executor import Scope as JScope
from paddle_tpu.models import resnet as jresnet

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import framework as tframework
from paddle_tpu_torch.fluid import lowering as tlowering
from paddle_tpu_torch.fluid import unique_name as tunique
from paddle_tpu_torch.fluid.executor import tensor_of_numpy
from paddle_tpu_torch.models import resnet as tresnet

import test_torch_training as ttrain

tfa = importlib.import_module('paddle_tpu_torch.ops.flash_attention')

BF16 = ml_dtypes.bfloat16
F32_TOL = 1e-5


def bf16_ulps(ref, n=2):
    """n bf16 ulps of the largest magnitude of `ref`."""
    m = float(np.abs(np.asarray(ref, np.float32)).max())
    return n * 2.0 ** (np.floor(np.log2(m)) - 7) if m > 0 else 0.0


def _as_f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x).astype(np.float32)


def _run_rules(op_type, ins, attrs, amp):
    """One rule in both packages on the same numpy inputs: (JAX out, port
    out) dicts of arrays / tensors."""
    jins = {k: [jnp.asarray(a) for a in vs] for k, vs in ins.items()}
    tins = {k: [tensor_of_numpy(a) for a in vs] for k, vs in ins.items()}
    jctx = jlowering.Ctx(jax.random.PRNGKey(0), amp=amp)
    tctx = tlowering.Ctx(torch.device('cpu'), amp=amp)
    return (jlowering.get_rule(op_type)(jins, attrs, jctx),
            tlowering.get_rule(op_type)(tins, attrs, tctx))


def _assert_rule_matches(jout, tout, slot):
    j, t = jout[slot], tout[slot]
    assert str(j.dtype) == str(t.dtype).replace('torch.', ''), \
        (slot, j.dtype, t.dtype)
    j32, t32 = _as_f32(j), _as_f32(t)
    if t.dtype == torch.bfloat16:
        tol = bf16_ulps(j32)
    else:
        tol = F32_TOL * max(float(np.abs(j32).max()), 1e-12)
    np.testing.assert_allclose(t32, j32, rtol=0, atol=tol, err_msg=slot)


def _rand(r, *shape, dtype=np.float32):
    return r.randn(*shape).astype(np.float32).astype(dtype)


@pytest.mark.parametrize('amp', [False, True])
@pytest.mark.parametrize('x_dtype', [np.float32, BF16])
def test_mul_rule_casts_as_the_jax_rule(amp, x_dtype):
    r = np.random.RandomState(1)
    ins = {'X': [_rand(r, 4, 3, 24, dtype=x_dtype)], 'Y': [_rand(r, 24, 5)]}
    if x_dtype is BF16 and not amp:
        ins['Y'] = [ins['Y'][0].astype(BF16)]
    jout, tout = _run_rules('mul', ins, {'x_num_col_dims': 2}, amp)
    _assert_rule_matches(jout, tout, 'Out')
    assert tuple(tout['Out'].shape) == (4, 3, 5)


@pytest.mark.parametrize('op_type', ['mul', 'matmul'])
def test_products_promote_mixed_dtypes_as_jnp(op_type):
    """AMP off, a bf16 x and an fp32 y (a bf16-fed net after its weights'
    first update): jnp promotes to fp32, the result cast to x's dtype."""
    r = np.random.RandomState(22)
    ins = {'X': [_rand(r, 5, 12, dtype=BF16)], 'Y': [_rand(r, 12, 3)]}
    jout, tout = _run_rules(op_type, ins, {}, False)
    _assert_rule_matches(jout, tout, 'Out')


@pytest.mark.parametrize('amp', [False, True])
@pytest.mark.parametrize('tx,ty', [(False, False), (True, False),
                                   (False, True)])
def test_matmul_rule_casts_as_the_jax_rule(amp, tx, ty):
    r = np.random.RandomState(2)
    x = _rand(r, 2, 3, 6, 8)
    y = _rand(r, 3, 8, 5)            # broadcast over x's leading batch dim
    if tx:
        x = np.ascontiguousarray(np.swapaxes(x, -1, -2))
    if ty:
        y = np.ascontiguousarray(np.swapaxes(y, -1, -2))
    attrs = {'transpose_X': tx, 'transpose_Y': ty, 'alpha': 0.5}
    jout, tout = _run_rules('matmul', {'X': [x], 'Y': [y]}, attrs, amp)
    _assert_rule_matches(jout, tout, 'Out')


@pytest.mark.parametrize('shapes', [((64, 96), (96, 40)),
                                    ((4, 3, 20, 32), (3, 32, 24))])
def test_card_product_backward_keeps_the_fp32_cotangent(monkeypatch,
                                                        shapes):
    """The card's AMP product (math_ops._Bf16Product) with its bf16 GEMM
    emulated as the GEMM computes it (the bf16 operands widened, exact,
    and summed in fp32; torch.mm's out_dtype is absent from CPU builds):
    its gradients against the CPU's exact form, which multiplies the fp32
    cotangent. The backward's hi + lo split keeps the cotangent to 2^-17
    relative, so a gradient element lands on the other bf16 neighbour
    only where its fp32 value lies within that of a rounding boundary: at
    most 1% of the elements, each by one bf16 ulp of max |g| (the
    cotangent rounded to bf16 once moves about 40% of them)."""
    from paddle_tpu_torch.fluid.ops_impl import math_ops
    monkeypatch.setattr(math_ops, '_bf16_mm', lambda x, y: torch.matmul(
        x.to(torch.float32), y.to(torch.float32)))
    r = np.random.RandomState(23)
    x = torch.tensor(_rand(r, *shapes[0])).to(torch.bfloat16)
    y = torch.tensor(_rand(r, *shapes[1])).to(torch.bfloat16)
    out_shape = torch.broadcast_shapes(x.shape[:-2], y.shape[:-2]) + (
        x.shape[-2], y.shape[-1])
    w = torch.tensor(_rand(r, *out_shape))
    grads = {}
    for form in ('card', 'exact'):
        a, b = x.clone().requires_grad_(), y.clone().requires_grad_()
        out = math_ops._Bf16Product.apply(a, b) if form == 'card' \
            else torch.matmul(a.to(torch.float32), b.to(torch.float32))
        assert out.dtype == torch.float32
        grads[form] = torch.autograd.grad((out * w).sum(), (a, b))
    for g, want in zip(grads['card'], grads['exact']):
        assert g.dtype == want.dtype == torch.bfloat16
        assert float((g != want).float().mean()) <= 0.01
        np.testing.assert_allclose(_as_f32(g), _as_f32(want), rtol=0,
                                   atol=bf16_ulps(_as_f32(want), n=1))


def test_matmul_layer_builds_the_jax_op():
    progs = []
    for fluid, framework, unique_name in ((jfluid, jframework, junique),
                                          (tfluid, tframework, tunique)):
        main, startup = framework.Program(), framework.Program()
        with unique_name.guard(), framework.program_guard(main, startup):
            x = fluid.layers.data(name='x', shape=[3, 4])
            y = fluid.layers.data(name='y', shape=[5, 4])
            fluid.layers.matmul(x, y, transpose_y=True, alpha=2.0)
        progs.append(main)
    ttrain._assert_same_program(*progs)


@pytest.mark.parametrize('amp', [False, True])
@pytest.mark.parametrize('fmt', ['NCHW', 'NHWC'])
@pytest.mark.parametrize('x_dtype', [np.float32, BF16])
def test_conv2d_rule_casts_as_the_jax_rule(amp, fmt, x_dtype):
    r = np.random.RandomState(3)
    shape = (2, 4, 9, 9) if fmt == 'NCHW' else (2, 9, 9, 4)
    ins = {'Input': [_rand(r, *shape, dtype=x_dtype)],
           'Filter': [_rand(r, 6, 4, 3, 3)]}
    attrs = {'strides': [2, 2], 'paddings': [1, 1], 'dilations': [1, 1],
             'groups': 1, 'data_format': fmt}
    jout, tout = _run_rules('conv2d', ins, attrs, amp)
    _assert_rule_matches(jout, tout, 'Output')


@pytest.mark.parametrize('amp', [False, True])
@pytest.mark.parametrize('causal', [False, True])
def test_flash_attention_rule_casts_as_the_jax_rule(amp, causal):
    r = np.random.RandomState(4)
    q, k, v = [_rand(r, 2, 3, 20, 16) for _ in range(3)]
    kb = np.zeros((2, 1, 1, 20), np.float32)
    kb[1, ..., 12:] = -1e9
    ins = {'Q': [q], 'K': [k], 'V': [v], 'KeyBias': [kb]}
    jout, tout = _run_rules('flash_attention', ins,
                            {'causal': causal, 'scale': -1.0}, amp)
    _assert_rule_matches(jout, tout, 'Out')
    assert (tout['Out'].dtype == torch.bfloat16) == amp


# -- the plain bf16 attention ------------------------------------------------

def _attention_inputs(seed, B=2, H=3, Tq=40, Tk=40, D=16):
    r = np.random.RandomState(seed)
    q, k, v = [_rand(r, B, H, T, D, dtype=BF16) for T in (Tq, Tk, Tk)]
    kb = np.zeros((B, Tk), np.float32)
    kb[0, Tk // 2:] = -1e9
    return q, k, v, kb


# the last two: batch row 1's bias masks every key (-1e9), at a ragged T
# (200 queries over 160 keys, and 200 causal): its scores sit near -1e9,
# where fp32 steps by 64 (the bf16 kernels' overflow case)
@pytest.mark.parametrize('causal,Tq,Tk,masked_row',
                         [(False, 40, 40, False), (True, 40, 40, False),
                          (False, 17, 40, False), (False, 200, 160, True),
                          (True, 200, 200, True)])
def test_plain_bf16_attention_matches_reference(causal, Tq, Tk, masked_row):
    q, k, v, kb = _attention_inputs(5, Tq=Tq, Tk=Tk)
    if masked_row:
        kb[1] = -1e9
    want = jops.reference_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), key_bias=jnp.asarray(kb),
                                    causal=causal)
    tq, tk, tv = map(tensor_of_numpy, (q, k, v))
    got = tfa.flash_attention(tq, tk, tv, key_bias=torch.tensor(kb),
                              causal=causal)
    assert got.dtype == torch.bfloat16 and str(want.dtype) == 'bfloat16'
    np.testing.assert_allclose(_as_f32(got), _as_f32(want), rtol=0,
                               atol=bf16_ulps(want))


@pytest.mark.parametrize('causal', [False, True])
def test_plain_bf16_attention_grads_match_jax_grad(causal):
    """dQ, dK, dV (bf16, as jax.grad gives them for bf16 inputs) of
    sum(O * wo) + sum(lse * wl) against jax.grad of the JAX package's
    flash_attention_lse oracle (reference_attention's O, its lse in
    fp32)."""
    q, k, v, kb = _attention_inputs(6)
    r = np.random.RandomState(7)
    wo = _rand(r, *q.shape, dtype=BF16)
    wl = _rand(r, *q.shape[:3])
    scale = q.shape[-1] ** -0.5

    def jloss(q, k, v):
        o = jops.reference_attention(q, k, v, key_bias=jnp.asarray(kb),
                                     causal=causal)
        s = jnp.einsum('bhqd,bhkd->bhqk', q.astype(jnp.float32),
                       k.astype(jnp.float32)) * scale
        s = s + jnp.asarray(kb)[:, None, None, :]
        if causal:
            T = q.shape[2]
            s = jnp.where(jnp.arange(T)[:, None] >= jnp.arange(T)[None, :],
                          s, -1e9)
        lse = jax.scipy.special.logsumexp(s, axis=-1)
        return (jnp.sum(o.astype(jnp.float32) * jnp.asarray(wo)
                        .astype(jnp.float32))
                + jnp.sum(lse * jnp.asarray(wl)))

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = [tensor_of_numpy(a).requires_grad_() for a in (q, k, v)]
    o, lse = tfa.flash_attention_lse(tq, tk, tv, key_bias=torch.tensor(kb),
                                     causal=causal)
    loss = (o.float() * tensor_of_numpy(wo).float()).sum() + \
        (lse * torch.tensor(wl)).sum()
    tgrads = torch.autograd.grad(loss, [tq, tk, tv])
    for name, j, t in zip('qkv', jgrads, tgrads):
        assert t.dtype == torch.bfloat16 and str(j.dtype) == 'bfloat16'
        np.testing.assert_allclose(_as_f32(t), _as_f32(j), rtol=0,
                                   atol=bf16_ulps(j), err_msg=name)


def test_plain_bf16_attention_lse_matches_the_fp32_lse():
    """The lse of bf16 inputs is the fp32 lse of the same (widened)
    values: products of bf16 values are exact in fp32."""
    q, k, v, kb = _attention_inputs(8)
    _, lse = tfa.flash_attention_lse_plain(*map(tensor_of_numpy, (q, k, v)),
                                           key_bias=torch.tensor(kb))
    _, lse32 = tfa.flash_attention_lse_plain(
        *[tensor_of_numpy(a).float() for a in (q, k, v)],
        key_bias=torch.tensor(kb))
    assert lse.dtype == torch.float32
    torch.testing.assert_close(lse, lse32, rtol=0, atol=F32_TOL)


# -- the rules a bf16 tower feeds ---------------------------------------------

def _bn_ins(r, shape, c):
    return {'X': [_rand(r, *shape, dtype=BF16)],
            'Scale': [(1 + 0.1 * r.randn(c)).astype(np.float32)],
            'Bias': [(0.1 * r.randn(c)).astype(np.float32)],
            'Mean': [(0.1 * r.randn(c)).astype(np.float32)],
            'Variance': [(1 + 0.1 * r.rand(c)).astype(np.float32)]}


@pytest.mark.parametrize('is_test', [False, True])
@pytest.mark.parametrize('layout', ['NCHW', 'NHWC'])
def test_batch_norm_on_bf16_activations(layout, is_test):
    """Stats in fp32 in both; Y in bf16. The JAX rule computes Y in bf16
    arithmetic, (x - mean) * (inv * scale) + bias with each factor and each
    step rounded to bf16, the port's F.batch_norm in fp32 with one
    rounding: they differ by a few roundings of |Y|, bounded here by
    four bf16 ulps of max |Y|."""
    r = np.random.RandomState(9)
    shape = (4, 6, 5, 5) if layout == 'NCHW' else (4, 5, 5, 6)
    ins = _bn_ins(r, shape, 6)
    attrs = {'epsilon': 1e-5, 'momentum': 0.9, 'data_layout': layout,
             'is_test': is_test}
    jout, tout = _run_rules('batch_norm', ins, attrs, True)
    assert tout['Y'].dtype == torch.bfloat16 and str(jout['Y'].dtype) == \
        'bfloat16'
    j = _as_f32(jout['Y'])
    np.testing.assert_allclose(_as_f32(tout['Y']), j, rtol=0,
                               atol=bf16_ulps(j, 4))
    for slot in ('MeanOut', 'VarianceOut', 'SavedMean', 'SavedVariance'):
        assert tout[slot].dtype == torch.float32, slot
        np.testing.assert_allclose(_as_f32(tout[slot]), _as_f32(jout[slot]),
                                   rtol=1e-5, atol=1e-5, err_msg=slot)


@pytest.mark.parametrize('param_dtype', [np.float32, BF16])
def test_batch_norm_rounds_bf16_y_once(param_dtype):
    """A bf16 tower's batch norm, Scale and Bias fp32 or bf16 (as a bf16
    data var declares them): Y is the normalization rounded to bf16 once,
    so it equals the fp64 value rounded but where the fp32 arithmetic
    lies within its rounding of a bf16 boundary (at most 0.1% of the
    elements; rounded along the way, about a third of them differ)."""
    r = np.random.RandomState(24)
    ins = _bn_ins(r, (2, 16, 12, 12), 16)
    ins['X'] = [(3 * _rand(r, 2, 16, 12, 12) + 1).astype(BF16)]
    for slot in ('Scale', 'Bias'):
        ins[slot] = [ins[slot][0].astype(param_dtype)]
    ctx = tlowering.Ctx(torch.device('cpu'), torch.Generator(), amp=True)
    y = tlowering.get_rule('batch_norm')(
        {s: [tensor_of_numpy(a) for a in v] for s, v in ins.items()},
        {'epsilon': 1e-5, 'momentum': 0.9, 'data_layout': 'NCHW'}, ctx)['Y']
    x = _as_f32(ins['X'][0]).astype(np.float64)
    m = x.mean(axis=(0, 2, 3), keepdims=True)
    v = x.var(axis=(0, 2, 3), keepdims=True)
    ref = (x - m) / np.sqrt(v + 1e-5) * \
        _as_f32(ins['Scale'][0]).reshape(1, -1, 1, 1) + \
        _as_f32(ins['Bias'][0]).reshape(1, -1, 1, 1)
    assert y.dtype == torch.bfloat16
    assert np.mean(_as_f32(y) != ref.astype(BF16).astype(np.float32)) \
        <= 1e-3


@pytest.mark.parametrize('op_type,attrs,shape', [
    ('relu', {}, (3, 4, 5)),
    ('softmax', {}, (6, 10)),
    ('pool2d', {'pooling_type': 'max', 'ksize': [3, 3], 'strides': [2, 2],
                'paddings': [1, 1]}, (2, 3, 9, 9)),
    ('pool2d', {'pooling_type': 'avg', 'global_pooling': True, 'ksize': [1, 1]},
     (2, 3, 7, 7)),
    ('mean', {}, (8, 5)),
    ('layer_norm', {'begin_norm_axis': 1, 'epsilon': 1e-5}, (6, 16)),
    ('clip', {'min': -0.5, 'max': 1.0}, (3, 4, 5)),
    ('relu6', {'threshold': 1.0}, (3, 4, 5)),
    ('brelu', {'t_min': -1.0, 't_max': 1.0}, (3, 4, 5)),
    ('leaky_relu', {'alpha': 0.1}, (3, 4, 5)),
    ('elu', {}, (3, 4, 5)),
    ('hard_sigmoid', {}, (3, 4, 5)),
    ('softshrink', {}, (3, 4, 5)),
    ('hard_shrink', {}, (3, 4, 5)),
    ('thresholded_relu', {}, (3, 4, 5)),
    ('abs', {}, (3, 4, 5)),
    ('tanh', {}, (3, 4, 5)),
    ('exp', {}, (3, 4, 5)),
    ('softplus', {}, (3, 4, 5)),
    ('logsigmoid', {}, (3, 4, 5)),
    ('swish', {}, (3, 4, 5)),
    ('stanh', {}, (3, 4, 5)),
    ('softsign', {}, (3, 4, 5)),
    ('tanh_shrink', {}, (3, 4, 5)),
    ('soft_relu', {}, (3, 4, 5)),
    ('reduce_max', {'dim': [1], 'keep_dim': False}, (3, 4, 5)),
    ('reduce_min', {'dim': [1], 'keep_dim': False}, (3, 4, 5)),
])
def test_unary_rules_on_bf16_activations(op_type, attrs, shape):
    """The same dtype out; values within two bf16 ulps of max |out| (a
    bf16 softmax: JAX subtracts, exponentiates, sums and divides in bf16,
    torch in fp32 with one rounding; a bf16 average pool: JAX sums in
    bf16; mean: the same)."""
    r = np.random.RandomState(10)
    jout, tout = _run_rules(op_type, {'X': [_rand(r, *shape, dtype=BF16)]},
                            attrs, True)
    slot = 'Y' if op_type == 'layer_norm' else 'Out'
    _assert_rule_matches(jout, tout, slot)


@pytest.mark.parametrize('op_type', ['elementwise_add', 'elementwise_mul'])
@pytest.mark.parametrize('y_dtype', [np.float32, BF16])
def test_elementwise_broadcast_on_bf16_activations(op_type, y_dtype):
    """bf16 x with an fp32 or bf16 y broadcast at axis 1: torch and jnp
    promote alike (bf16 with fp32 is fp32)."""
    r = np.random.RandomState(11)
    ins = {'X': [_rand(r, 2, 3, 4, dtype=BF16)],
           'Y': [_rand(r, 3, dtype=y_dtype)]}
    jout, tout = _run_rules(op_type, ins, {'axis': 1}, True)
    _assert_rule_matches(jout, tout, 'Out')


def test_cross_entropy_on_a_bf16_softmax():
    r = np.random.RandomState(12)
    x = np.exp(r.randn(6, 10)).astype(np.float32)
    x = (x / x.sum(1, keepdims=True)).astype(BF16)
    label = r.randint(0, 10, (6, 1)).astype(np.int64)
    jout, tout = _run_rules('cross_entropy', {'X': [x], 'Label': [label]},
                            {}, True)
    _assert_rule_matches(jout, tout, 'Y')


# -- the small Transformer under decorate_program ----------------------------

def _amp_train(pkg):
    """test_torch_training's dropout-free Adam program at 2+2 layers,
    under decorate_program."""
    fluid, framework, unique_name, transformer, _ = pkg
    main, startup = framework.Program(), framework.Program()
    with unique_name.guard(), framework.program_guard(main, startup):
        avg_cost, _, _ = transformer.transformer(
            ttrain.V, ttrain.V, ttrain.T, 2, ttrain.CFG['d_model'],
            ttrain.CFG['n_head'], ttrain.CFG['d_inner'], dropout_rate=0.0)
        lr = fluid.layers.learning_rate_scheduler.noam_decay(
            ttrain.CFG['d_model'], ttrain.WARMUP)
        fluid.optimizer.Adam(learning_rate=fluid.layers.scale(lr, scale=2.0),
                             beta1=0.9, beta2=0.98,
                             epsilon=1e-9).minimize(avg_cost)
    fluid.amp.decorate_program(main)
    return main, startup, avg_cost.name


@pytest.fixture(scope='module')
def amp_transformer_runs():
    """3 AMP steps in each package from JAX's startup weights, and JAX's
    step 1 of the same program without AMP."""
    feeds = ttrain._feeds(3)
    main, startup, loss = _amp_train(ttrain.JAX)
    gnames = ttrain._grad_names(main)
    scope = JScope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(startup)
        init = {n: np.array(v, copy=True) for n, v in scope.vars.items()}
        jout = [exe.run(main, feed=f, fetch_list=[loss] + gnames)
                for f in feeds]
    fp32 = JScope()
    with jfluid.scope_guard(fp32):
        fp32.vars.update((n, np.array(v, copy=True)) for n, v in init.items())
        jfluid.amp.decorate_program(main, enable=False)
        j32 = jfluid.Executor(jfluid.CPUPlace()).run(
            main, feed=feeds[0], fetch_list=[loss] + gnames)
    tmain, _, tloss = _amp_train(ttrain.PORT)
    assert tfluid.amp.is_amp(tmain)
    tscope = tfluid.Scope()
    tscope.load_numpy(init, tfluid.CPUPlace())
    texe = tfluid.Executor(tfluid.CPUPlace())
    tout = [texe.run(tmain, feed=f, fetch_list=[tloss] + gnames,
                     scope=tscope) for f in feeds]
    return gnames, jout, tout, j32


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b)) / max(float(np.linalg.norm(b)),
                                              1e-12)


def test_amp_transformer_step_one_gradients_match_jax(amp_transformer_runs):
    """Each step-1 gradient of the port within the distance AMP itself
    puts between JAX's bf16 and fp32 gradients (relative L2; measured:
    at most 0.80 of it, median 0.10), the median within a quarter."""
    gnames, jout, tout, j32 = amp_transformer_runs
    assert len(gnames) > 20
    ratios = []
    for i, name in enumerate(gnames, 1):
        j = np.asarray(jout[0][i]).astype(np.float32)
        t = tout[0][i]
        assert t.dtype == np.float32 and t.shape == j.shape, name
        err, amp_err = _rel_l2(t, j), _rel_l2(j, j32[i])
        assert err <= amp_err, (name, err, amp_err)
        ratios.append(err / amp_err)
    assert float(np.median(ratios)) <= 0.25, float(np.median(ratios))


def test_amp_transformer_losses_match_jax(amp_transformer_runs):
    _, jout, tout, _ = amp_transformer_runs
    jl = [float(np.asarray(o[0]).reshape(())) for o in jout]
    tl = [float(o[0].reshape(())) for o in tout]
    assert all(o[0].dtype == np.float32 for o in tout)
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    assert jl[2] < jl[0]


# -- a small ResNet on a bf16 feed -------------------------------------------

def _cifar_tower(fluid, resnet, img, fmt):
    """resnet_cifar10 at depth 8 (the stem and one basic block a stage),
    built from the models' own helpers in either layout (the model
    function itself builds NCHW only)."""
    conv1 = resnet.conv_bn_layer(img, 16, 3, 1, 1, data_format=fmt)
    res = conv1
    for ch, stride in ((16, 1), (32, 2), (64, 2)):
        res = resnet.layer_warp(resnet.basicblock, res, ch, 1, stride,
                                data_format=fmt)
    pool = fluid.layers.pool2d(input=res, pool_size=8, pool_type='avg',
                               pool_stride=1, data_format=fmt)
    return fluid.layers.fc(input=pool, size=10, act='softmax')


def _bf16_resnet(pkg, fmt):
    """bench.py:215-253's AMP build on the cifar10 tower: a bfloat16 data
    var, Momentum(0.01, 0.9), decorate_program."""
    fluid, framework, unique_name, resnet = pkg
    main, startup = framework.Program(), framework.Program()
    shape = [3, 32, 32] if fmt == 'NCHW' else [32, 32, 3]
    with unique_name.guard(), framework.program_guard(main, startup):
        img = fluid.layers.data(name='data', shape=shape, dtype='bfloat16')
        label = fluid.layers.data(name='label', shape=[1], dtype='int64')
        predict = _cifar_tower(fluid, resnet, img, fmt)
        avg_cost = fluid.layers.mean(
            fluid.layers.cross_entropy(input=predict, label=label))
        fluid.optimizer.Momentum(learning_rate=0.01, momentum=0.9) \
            .minimize(avg_cost)
        fluid.amp.decorate_program(main)
    return main, startup, avg_cost.name


@pytest.mark.parametrize('fmt', ['NCHW', 'NHWC'])
def test_bf16_resnet_trains_as_the_jax_one(fmt):
    r = np.random.RandomState(13)
    shape = (4, 3, 32, 32) if fmt == 'NCHW' else (4, 32, 32, 3)
    feeds = [{'data': r.rand(*shape).astype(np.float32),
              'label': r.randint(0, 10, (4, 1)).astype(np.int64)}
             for _ in range(3)]
    main, startup, loss = _bf16_resnet(
        (jfluid, jframework, junique, jresnet), fmt)
    scope = JScope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(startup)
        init = {n: np.array(v, copy=True) for n, v in scope.vars.items()}
        jl = [float(np.asarray(exe.run(
            main, feed={'data': f['data'].astype(BF16),
                        'label': f['label']}, fetch_list=[loss])[0])
            .astype(np.float32).reshape(())) for f in feeds]
    tmain, _, tloss = _bf16_resnet((tfluid, tframework, tunique, tresnet),
                                   fmt)
    tscope = tfluid.Scope()
    tscope.load_numpy(init, tfluid.CPUPlace())
    texe = tfluid.Executor(tfluid.CPUPlace())
    outs = [texe.run(tmain, feed=f, fetch_list=[tloss], scope=tscope)[0]
            for f in feeds]
    # the loss is a bf16 mean, fetched widened to float32
    assert all(o.dtype == np.float32 for o in outs)
    tl = [float(o.reshape(())) for o in outs]
    assert all(np.isfinite(tl))
    np.testing.assert_allclose(tl, jl, rtol=1e-2)
    # master weights and velocities stay fp32
    assert all(v.dtype == torch.float32 for n, v in tscope.vars.items()
               if n.startswith(('velocity_', 'conv2d_')) and
               v.is_floating_point())


# -- AMP against fp32 in the port --------------------------------------------

def _regression(amp, steps=10):
    """JAX tests/test_amp.py's net and data, in the port."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tunique.guard(), tframework.program_guard(main, startup):
        x = tfluid.layers.data(name='x', shape=[16], dtype='float32')
        y = tfluid.layers.data(name='y', shape=[1], dtype='float32')
        h = tfluid.layers.fc(input=x, size=32, act='relu')
        pred = tfluid.layers.fc(input=h, size=1)
        cost = tfluid.layers.mean(
            tfluid.layers.square_error_cost(input=pred, label=y))
        tfluid.optimizer.SGD(learning_rate=0.05).minimize(cost)
    if amp:
        tfluid.amp.decorate_program(main)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(3)
    xs = rng.rand(32, 16).astype('float32')
    ys = (xs.sum(axis=1, keepdims=True) * 0.1).astype('float32')
    losses = []
    for _ in range(steps):
        loss, = exe.run(main, feed={'x': xs, 'y': ys}, fetch_list=[cost],
                        scope=scope)
        assert loss.dtype == np.float32
        losses.append(float(loss[0]))
    return losses, exe


def test_amp_trajectory_stays_near_fp32():
    fp32, _ = _regression(False)
    bf16, exe = _regression(True)
    assert bf16[-1] < bf16[0], 'amp training diverged'
    np.testing.assert_allclose(fp32, bf16, rtol=0.1, atol=1e-2)
    assert not np.array_equal(fp32, bf16)
    assert exe.cache_stats['misses'] == 2      # startup, the AMP step


def test_amp_flag_is_part_of_the_step_key():
    """One program run with and without AMP builds two artifacts; the
    amp_guard arms the flag for a run without decorating."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tunique.guard(), tframework.program_guard(main, startup):
        x = tfluid.layers.data(name='x', shape=[8])
        out = tfluid.layers.fc(input=x, size=4)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    feed = {'x': np.random.RandomState(0).randn(2, 8).astype('float32')}
    fp32 = exe.run(main, feed=feed, fetch_list=[out], scope=scope)[0]
    with tfluid.amp.amp_guard():
        half = exe.run(main, feed=feed, fetch_list=[out], scope=scope)[0]
    arts = [a for a in exe._cache.values() if a.program is main]
    assert sorted(a.amp for a in arts) == [False, True]
    assert half.dtype == fp32.dtype == np.float32
    assert not np.array_equal(half, fp32)
    np.testing.assert_allclose(half, fp32, rtol=0, atol=0.05)
    # decorate_program bumps the version: a new key again
    tfluid.amp.decorate_program(main)
    exe.run(main, feed=feed, fetch_list=[out], scope=scope)
    assert exe._last_cache_lookup['outcome'] == 'miss'


@pytest.mark.parametrize('for_test', [False, True])
def test_clone_carries_the_amp_flags(for_test):
    main, startup = tfluid.Program(), tfluid.Program()
    with tunique.guard(), tframework.program_guard(main, startup):
        x = tfluid.layers.data(name='x', shape=[8])
        tfluid.layers.fc(input=x, size=4)
    tfluid.amp.decorate_program(main)
    main._fetch_f32 = True
    clone = main.clone(for_test=for_test)
    assert tfluid.amp.is_amp(clone) and clone._fetch_f32
    plain = tfluid.Program().clone()
    assert not tfluid.amp.is_amp(plain)
    assert not getattr(plain, '_fetch_f32', False)


# -- top_k over bf16 ----------------------------------------------------------

@pytest.mark.parametrize('dtype', [BF16, np.float16])
@pytest.mark.parametrize('k', [1, 3, 6])
def test_top_k_orders_half_floats_as_lax(dtype, k):
    x = np.array([[0.0, -0.0, 1.0, 1.0, np.nan, -np.inf, 0.5, -0.0],
                  [-0.0, 0.0, -1.0, np.inf, -1.0, 2.0, 2.0, 0.0],
                  [np.nan, 3.0, -0.0, -0.0, 0.0, 0.0, 3.0, -2.0]],
                 np.float32).astype(dtype)
    jout, tout = _run_rules('top_k', {'X': [x]}, {'k': k}, False)
    np.testing.assert_array_equal(tout['Indices'].numpy(),
                                  np.asarray(jout['Indices']))
    # the values: NaN where JAX has NaN (torch's CPU gather does not keep
    # a bf16 NaN's payload), every other value bit for bit (+-0.0 too)
    got = tout['Out'].view(torch.int16).numpy()
    want = np.asarray(jout['Out']).view(np.int16)
    nan = np.isnan(np.asarray(jout['Out']).astype(np.float32))
    np.testing.assert_array_equal(np.isnan(_as_f32(tout['Out'])), nan)
    np.testing.assert_array_equal(got[~nan], want[~nan])


# -- Queue C: out-of-range labels and ids ------------------------------------

PROBS = np.array([[0.2, 0.3, 0.5]], np.float32)


@pytest.mark.parametrize('label', [3, -1, -3, -4, 7])
@pytest.mark.parametrize('op_type', ['cross_entropy',
                                     'softmax_with_cross_entropy'])
def test_out_of_range_labels_give_the_jax_values(op_type, label):
    x_slot, out = ('X', 'Y') if op_type == 'cross_entropy' \
        else ('Logits', 'Loss')
    ins = {x_slot: [PROBS], 'Label': [np.array([[label]], np.int64)]}
    jout, tout = _run_rules(op_type, ins, {}, False)
    j, t = np.asarray(jout[out]), tout[out].numpy()
    np.testing.assert_array_equal(np.isnan(t), np.isnan(j))
    np.testing.assert_allclose(t, j, rtol=1e-6)
    if label in (3, -4, 7):
        assert np.isnan(t).all()


@pytest.mark.parametrize('ids', [[[5]], [[-1]], [[-4]], [[-5]], [[0], [3]],
                                 [[1], [9], [-2]]])
@pytest.mark.parametrize('padding_idx', [-1, 3])
def test_out_of_range_ids_give_the_jax_rows(ids, padding_idx):
    w = np.arange(12, dtype=np.float32).reshape(4, 3)
    ins = {'W': [w], 'Ids': [np.array(ids, np.int64)]}
    jout, tout = _run_rules('lookup_table', ins,
                            {'padding_idx': padding_idx}, False)
    j, t = np.asarray(jout['Out']), tout['Out'].numpy()
    assert t.shape == j.shape
    np.testing.assert_array_equal(t, j)


def test_an_out_of_range_label_gives_a_nan_loss_in_a_step():
    """Through the Executor, as a training step sees it: the loss is NaN,
    not an error (the anomaly guard then skips the step)."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tunique.guard(), tframework.program_guard(main, startup):
        x = tfluid.layers.data(name='x', shape=[4])
        label = tfluid.layers.data(name='label', shape=[1], dtype='int64')
        prob = tfluid.layers.fc(input=x, size=3, act='softmax')
        loss = tfluid.layers.mean(tfluid.layers.cross_entropy(prob, label))
        tfluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    tfluid.executor.anomaly_guard(main)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    before = scope.to_numpy()
    with pytest.warns(RuntimeWarning, match='skipped'):
        out = exe.run(main, feed={'x': np.ones((2, 4), 'float32'),
                                  'label': np.array([[1], [3]])},
                      fetch_list=[loss], scope=scope)[0]
    assert np.isnan(out).all() and exe.skipped_steps == 1
    after = scope.to_numpy(sorted(before))
    assert all(np.array_equal(after[n], before[n]) for n in before)


# -- bf16 through numpy ------------------------------------------------------

def test_scope_carries_bf16_arrays_bit_for_bit():
    r = np.random.RandomState(14)
    a = _rand(r, 5, 7, dtype=BF16)
    scope = tfluid.Scope()
    scope.load_numpy({'w': a, 'v': a.astype(np.float32)}, tfluid.CPUPlace())
    assert scope.vars['w'].dtype == torch.bfloat16
    assert scope.vars['v'].dtype == torch.float32
    np.testing.assert_array_equal(scope.vars['w'].view(torch.int16).numpy(),
                                  a.view(np.int16))
    out = scope.to_numpy(['w'])['w']
    # widened to float32, exactly
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out, a.astype(np.float32))


def test_bf16_feeds_round_as_jax_and_fetch_widened():
    main, startup = tfluid.Program(), tfluid.Program()
    with tunique.guard(), tframework.program_guard(main, startup):
        x = tfluid.layers.data(name='x', shape=[6], dtype='bfloat16')
        y = tfluid.layers.scale(x, scale=1.0)
    exe = tfluid.Executor(tfluid.CPUPlace())
    r = np.random.RandomState(15)
    xs = r.randn(3, 6).astype(np.float32)
    scope = tfluid.Scope()
    for fed in (xs, xs.astype(BF16), torch.tensor(xs)):
        got, = exe.run(main, feed={'x': fed}, fetch_list=[y], scope=scope)
        # torch's float -> bf16 rounding is numpy's ml_dtypes rounding
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, xs.astype(BF16)
                                      .astype(np.float32))
    assert exe.cache_stats['misses'] == 1       # one feed signature
    art = list(exe._cache.values())[0]
    assert art._feed_sig == (('x', (3, 6), 'bfloat16'),)


def test_data_feeder_makes_bf16_through_torch():
    main, startup = tfluid.Program(), tfluid.Program()
    with tunique.guard(), tframework.program_guard(main, startup):
        img = tfluid.layers.data(name='img', shape=[2, 3], dtype='bfloat16')
        label = tfluid.layers.data(name='label', shape=[1], dtype='int64')
    feeder = tfluid.DataFeeder([img, label], tfluid.CPUPlace(),
                               program=main)
    r = np.random.RandomState(16)
    rows = [(r.randn(6).astype(np.float32), i) for i in range(4)]
    out = feeder.feed(rows)
    assert out['img'].dtype == torch.bfloat16
    assert tuple(out['img'].shape) == (4, 2, 3)
    want = np.stack([x for x, _ in rows]).reshape(4, 2, 3).astype(BF16)
    np.testing.assert_array_equal(out['img'].view(torch.int16).numpy(),
                                  want.view(np.int16))
    assert out['label'].dtype == np.int64


def _sparse_net(fluid, framework, unique_name, opt):
    main, startup = framework.Program(), framework.Program()
    with unique_name.guard(), framework.program_guard(main, startup):
        ids = fluid.layers.data(name='ids', shape=[1], dtype='int64')
        y = fluid.layers.data(name='y', shape=[1], dtype='float32')
        e = fluid.layers.embedding(ids, size=[4, 3], is_sparse=True)
        p = fluid.layers.fc(e, size=1)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(p, y))
        {'sgd': lambda: fluid.optimizer.SGD(0.1),
         'adagrad': lambda: fluid.optimizer.Adagrad(0.1),
         'adam': lambda: fluid.optimizer.Adam(0.1)}[opt]().minimize(loss)
    return main, startup, loss.name


@pytest.mark.parametrize('ids', [[[1], [5]], [[1], [-1]], [[-4], [2]],
                                 [[3], [-5]]])
@pytest.mark.parametrize('opt', ['sgd', 'adagrad', 'adam'])
def test_out_of_range_ids_in_a_sparse_step_match_jax(opt, ids):
    """The is_sparse table's gradient rows (the taps) follow the lookup's
    id rule: a negative id updates its wrapped row, an id past the table
    none, as JAX's scatter drops it; the loss and the table after one step
    equal the JAX package's (1e-6), NaN where JAX has NaN."""
    feed = {'ids': np.array(ids, np.int64), 'y': np.ones((2, 1), np.float32)}
    main, startup, loss = _sparse_net(jfluid, jframework, junique, opt)
    scope = JScope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(startup)
        init = {n: np.array(v, copy=True) for n, v in scope.vars.items()}
        jl, = exe.run(main, feed=feed, fetch_list=[loss])
        jw = np.array(scope.vars['embedding_0.w_0'])
    tmain, _, tloss = _sparse_net(tfluid, tframework, tunique, opt)
    tscope = tfluid.Scope()
    tscope.load_numpy(init, tfluid.CPUPlace())
    texe = tfluid.Executor(tfluid.CPUPlace())
    tl, = texe.run(tmain, feed=feed, fetch_list=[tloss], scope=tscope)
    art = list(texe._cache.values())[0]
    assert list(art.sparse_plan) == ['embedding_0.w_0']
    np.testing.assert_allclose(tl, np.asarray(jl), rtol=1e-6)
    np.testing.assert_allclose(tscope.to_numpy()['embedding_0.w_0'], jw,
                               rtol=0, atol=1e-6)
    live = {(i + 4) % 4 for (i,) in ids if -4 <= i < 4}
    assert set(art.touched_rows(feed)['embedding_0.w_0']) == live
