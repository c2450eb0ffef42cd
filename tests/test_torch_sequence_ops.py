"""The sequence rules of the PyTorch port (ops_impl/sequence_ops.py,
ops_impl/extra_ops.py's three sequence rules, nn_ops.im2sequence) against
the JAX package's rule for the same op type, called directly in both
packages on the same seeded numpy inputs: the outputs (data, lengths and
outer lengths of a sequence) and the gradient of a seeded cotangent with
respect to every float input (jax.vjp against torch.autograd).

The sequences are ragged: each batch holds a zero-length row and a row as
long as the padded axis. Values are held at VALUE_TOL (1e-6, rtol and
atol), gradients at GRAD_TOL (1e-5). Lengths are int32 in the JAX package
(x64 off) and int64 in the port: they compare by value. MAX pooling at a
tie shares the gradient evenly in both; 2-level input pools the inner
level and regroups under the outer one.
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

VALUE_TOL = 1e-6
GRAD_TOL = 1e-5

B, T = 4, 5
LENS = np.array([3, 0, T, 1])            # a zero-length and a full row


class Seq(object):
    """A sequence input: padded data, lengths and outer levels (numpy)."""

    def __init__(self, data, lengths=LENS, outer=()):
        self.data = np.asarray(data)
        self.lengths = np.asarray(lengths)
        self.outer = tuple(np.asarray(o) for o in outer)


def _seq_data(rng, *trail, lengths=LENS, t=T, dtype='float32'):
    """Padded data [len(lengths), t, *trail] with zeros past each length
    (as the feeder pads)."""
    x = rng.randn(len(lengths), t, *trail).astype(dtype)
    for i, n in enumerate(lengths):
        x[i, n:] = 0
    return Seq(x, lengths)


def _to_jax(v, arr=None):
    if isinstance(v, Seq):
        return jlow.SeqValue(jnp.asarray(v.data) if arr is None else arr,
                             jnp.asarray(v.lengths, jnp.int32),
                             tuple(jnp.asarray(o, jnp.int32)
                                   for o in v.outer) or None)
    return jnp.asarray(v) if arr is None else arr


def _to_port(v, t=None):
    if isinstance(v, Seq):
        return tlow.SeqValue(torch.from_numpy(v.data.copy()) if t is None
                             else t,
                             torch.from_numpy(v.lengths.astype('int64')),
                             tuple(torch.from_numpy(o.astype('int64'))
                                   for o in v.outer) or None)
    return torch.from_numpy(np.array(v)) if t is None else t


def _ctx_jax():
    return jlow.Ctx(jax.random.key(0), is_test=False, platform='cpu')


def _ctx_port():
    return tlow.Ctx(torch.device('cpu'), torch.Generator())


def _float_inputs(ins):
    """(slot, index) of every float input, in a fixed order."""
    out = []
    for slot in sorted(ins):
        for i, v in enumerate(ins[slot]):
            a = v.data if isinstance(v, Seq) else np.asarray(v)
            if a.dtype.kind == 'f':
                out.append((slot, i))
    return out


def _run_jax(op_type, ins, attrs, arrays=None):
    jins = {s: [_to_jax(v) for v in vs] for s, vs in ins.items()}
    for (slot, i), a in (arrays or {}).items():
        jins[slot][i] = _to_jax(ins[slot][i], a)
    return jlow.get_rule(op_type)(jins, attrs, _ctx_jax())


def _run_port(op_type, ins, attrs, tensors=None):
    tins = {s: [_to_port(v) for v in vs] for s, vs in ins.items()}
    for (slot, i), t in (tensors or {}).items():
        tins[slot][i] = _to_port(ins[slot][i], t)
    return tlow.get_rule(op_type)(tins, attrs, _ctx_port())


def _data(v):
    return v.data if isinstance(v, (jlow.SeqValue, tlow.SeqValue)) else v


def _compare_value(j, t, what):
    assert isinstance(t, tlow.SeqValue) == isinstance(j, jlow.SeqValue), what
    if isinstance(j, jlow.SeqValue):
        np.testing.assert_array_equal(t.lengths.numpy(),
                                      np.asarray(j.lengths), what)
        jo, to = j.outer_lengths or (), t.outer_lengths or ()
        assert len(jo) == len(to), what
        for a, b in zip(to, jo):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), what)
    jd, td = np.asarray(_data(j)), _data(t).detach().numpy()
    assert jd.shape == td.shape, (what, jd.shape, td.shape)
    if jd.dtype.kind in 'iub':
        np.testing.assert_array_equal(td, jd, what)
    else:
        assert td.dtype == jd.dtype, (what, td.dtype, jd.dtype)
        np.testing.assert_allclose(td, jd, rtol=VALUE_TOL, atol=VALUE_TOL,
                                   err_msg=what)


def check(op_type, ins, attrs, slots, grad_slot=None, seed=11):
    """Forward in both packages: every output of `slots` equal within
    VALUE_TOL. Then, when grad_slot is given, the VJP of that output's
    data at a seeded cotangent with respect to every float input, within
    GRAD_TOL. Returns the port's outputs."""
    jouts = _run_jax(op_type, ins, attrs)
    touts = _run_port(op_type, ins, attrs)
    for slot in slots:
        _compare_value(jouts[slot], touts[slot], '%s.%s' % (op_type, slot))
    if grad_slot is None:
        return touts
    keys = _float_inputs(ins)
    assert keys, op_type

    def raw(v):
        return v.data if isinstance(v, Seq) else np.asarray(v)

    def jf(*arrays):
        out = _run_jax(op_type, ins, attrs, dict(zip(keys, arrays)))
        return _data(out[grad_slot])

    primals = [jnp.asarray(raw(ins[s][i])) for s, i in keys]
    out, pull = jax.vjp(jf, *primals)
    cot = np.random.RandomState(seed).randn(*out.shape).astype(out.dtype)
    jgrads = pull(jnp.asarray(cot))
    leaves = [torch.from_numpy(raw(ins[s][i]).copy()).requires_grad_(True)
              for s, i in keys]
    tout = _data(_run_port(op_type, ins, attrs,
                           dict(zip(keys, leaves)))[grad_slot])
    tgrads = torch.autograd.grad(tout, leaves, torch.from_numpy(cot),
                                 allow_unused=True)
    for (s, i), leaf, jg, tg in zip(keys, leaves, jgrads, tgrads):
        tg = np.zeros(leaf.shape, 'float32') if tg is None else tg.numpy()
        np.testing.assert_allclose(
            tg, np.asarray(jg), rtol=GRAD_TOL, atol=GRAD_TOL,
            err_msg='d %s.%s / d %s[%d]' % (op_type, grad_slot, s, i))
    return touts


# -- sequence_pool ----------------------------------------------------------

@pytest.mark.parametrize('ptype', ['SUM', 'AVERAGE', 'SQRT', 'MAX', 'FIRST',
                                   'LAST'])
def test_sequence_pool(ptype):
    x = _seq_data(np.random.RandomState(0), 3)
    check('sequence_pool', {'X': [x]}, {'pooltype': ptype}, ['Out'], 'Out')


def test_sequence_pool_max_shares_a_tie():
    x = _seq_data(np.random.RandomState(1), 2)
    x.data[0, :3, 0] = 2.0                    # three equal maxima
    x.data[2, 1, 1] = x.data[2, 3, 1] = 9.0   # two
    out = check('sequence_pool', {'X': [x]}, {'pooltype': 'MAX'}, ['Out'],
                'Out')
    xt = _to_port(x)
    xt.data.requires_grad_(True)
    y = tlow.get_rule('sequence_pool')({'X': [xt]}, {'pooltype': 'MAX'},
                                       _ctx_port())['Out']
    g, = torch.autograd.grad(y.sum(), xt.data)
    np.testing.assert_allclose(g[0, :3, 0].numpy(), [1 / 3.] * 3)
    np.testing.assert_allclose(g[2, [1, 3], 1].numpy(), [0.5, 0.5])
    assert out['Out'].shape == (B, 2)


@pytest.mark.parametrize('ptype', ['SUM', 'MAX', 'LAST'])
def test_sequence_pool_nested_lod(ptype):
    """Four inner sequences in three groups of 2, 0 and 2: the pooled rows
    regroup under the outer level, which becomes the lengths."""
    x = _seq_data(np.random.RandomState(2), 3)
    x.outer = (np.array([2, 0, 2]),)
    out = check('sequence_pool', {'X': [x]}, {'pooltype': ptype}, ['Out'],
                'Out')['Out']
    assert isinstance(out, tlow.SeqValue) and out.data.shape == (3, B, 3)
    assert out.outer_lengths is None


def test_sequence_pool_two_outer_levels():
    x = _seq_data(np.random.RandomState(3), 2)
    x.outer = (np.array([1, 1]), np.array([3, 1]))
    out = check('sequence_pool', {'X': [x]}, {'pooltype': 'AVERAGE'},
                ['Out'], 'Out')['Out']
    assert len(out.outer_lengths) == 1


# -- the other sequence rules ------------------------------------------------

def test_sequence_softmax():
    check('sequence_softmax', {'X': [_seq_data(np.random.RandomState(4),
                                               1)]}, {}, ['Out'], 'Out')


@pytest.mark.parametrize('x_is_seq', [False, True])
def test_sequence_expand(x_is_seq):
    rng = np.random.RandomState(5)
    x = _seq_data(rng, 3) if x_is_seq else rng.randn(B, 3).astype('float32')
    y = _seq_data(rng, 2, t=6)
    check('sequence_expand', {'X': [x], 'Y': [y]}, {'ref_level': -1},
          ['Out'], 'Out')


@pytest.mark.parametrize('new_dim', [3, 12])
def test_sequence_reshape(new_dim):
    x = _seq_data(np.random.RandomState(6), 6, t=4, lengths=[3, 0, 4, 1])
    x.outer = (np.array([4]),)
    out = check('sequence_reshape', {'X': [x]}, {'new_dim': new_dim},
                ['Out'], 'Out')['Out']
    assert out.outer_lengths is None


@pytest.mark.parametrize('dtype', ['int64', 'float32', 'bool'])
def test_sequence_mask(dtype):
    lens = np.array([3, 0, 6, 1], 'int64')
    check('sequence_mask', {'X': [lens]}, {'maxlen': 6, 'out_dtype': dtype},
          ['Y'])


def test_sequence_mask_needs_a_static_maxlen():
    with pytest.raises(ValueError, match='static maxlen'):
        _run_port('sequence_mask', {'X': [np.array([2, 3])]},
                  {'maxlen': -1, 'out_dtype': 'int64'})


@pytest.mark.parametrize('case', ['y_lengths', 'y_seq', 'target_seq',
                                  'target_dense', 'target_same_count'])
def test_lod_reset(case):
    rng = np.random.RandomState(7)
    x = _seq_data(rng, 2)
    attrs, ins = {}, {'X': [x]}
    if case == 'y_lengths':
        ins['Y'] = [np.array([2, 1, 0, 4], 'int64')]
    elif case == 'y_seq':
        ins['Y'] = [_seq_data(rng, 1, lengths=[1, 2, 3, 0])]
    elif case == 'target_seq':
        attrs['target_lod'] = [0, 2, 2, 7, 9]     # 9 valid rows, 4 seqs
    elif case == 'target_dense':
        ins['X'] = [rng.randn(10, 2).astype('float32')]
        attrs['target_lod'] = [0, 3, 10]
    else:
        attrs['target_lod'] = [0, 4, 5, 5, 9]
    check('lod_reset', ins, attrs, ['Out'], 'Out')


@pytest.mark.parametrize('clen,cstart', [(3, -1), (4, -2), (2, 0)])
def test_sequence_conv(clen, cstart):
    rng = np.random.RandomState(8)
    x = _seq_data(rng, 3, t=6, lengths=[3, 0, 6, 1])
    f = rng.randn(clen * 3, 4).astype('float32')
    check('sequence_conv', {'X': [x], 'Filter': [f]},
          {'contextLength': clen, 'contextStart': cstart,
           'contextStride': 1}, ['Out'], 'Out')


def test_row_conv():
    rng = np.random.RandomState(9)
    x = _seq_data(rng, 3)
    check('row_conv', {'X': [x], 'Filter': [rng.randn(3, 3).astype(
        'float32')]}, {}, ['Out'], 'Out')


# -- recurrences ---------------------------------------------------------

D = 3


def _lstm_ins(rng, peepholes, state=False):
    x = _seq_data(rng, 4 * D)
    ins = {'Input': [x],
           'Weight': [rng.randn(D, 4 * D).astype('float32') * 0.5],
           'Bias': [rng.randn(1, (7 if peepholes else 4) * D).astype(
               'float32') * 0.5]}
    if state:
        ins['H0'] = [rng.randn(B, D).astype('float32')]
        ins['C0'] = [rng.randn(B, D).astype('float32')]
    return ins


@pytest.mark.parametrize('peepholes', [True, False])
@pytest.mark.parametrize('reverse', [False, True])
@pytest.mark.parametrize('slot', ['Hidden', 'Cell'])
def test_lstm(peepholes, reverse, slot):
    ins = _lstm_ins(np.random.RandomState(10), peepholes)
    check('lstm', ins, {'use_peepholes': peepholes, 'is_reverse': reverse},
          ['Hidden', 'Cell'], slot)


@pytest.mark.parametrize('acts', [('sigmoid', 'tanh', 'tanh'),
                                  ('sigmoid', 'relu', 'identity')])
def test_lstm_with_state_and_activations(acts):
    ins = _lstm_ins(np.random.RandomState(12), True, state=True)
    ins['Input'][0].data[0, :3, :D] = 0.0     # relu's tie at 0
    ga, ca, cea = acts
    check('lstm', ins, {'use_peepholes': True, 'is_reverse': False,
                        'gate_activation': ga, 'candidate_activation': ca,
                        'cell_activation': cea}, ['Hidden', 'Cell'],
          'Hidden')


@pytest.mark.parametrize('reverse', [False, True])
def test_lstmp(reverse):
    rng = np.random.RandomState(13)
    P = 2
    ins = {'Input': [_seq_data(rng, 4 * D)],
           'Weight': [rng.randn(P, 4 * D).astype('float32') * 0.5],
           'ProjWeight': [rng.randn(D, P).astype('float32') * 0.5],
           'Bias': [rng.randn(1, 7 * D).astype('float32') * 0.5]}
    check('lstmp', ins, {'use_peepholes': True, 'is_reverse': reverse},
          ['Projection', 'Cell'], 'Projection')


@pytest.mark.parametrize('reverse', [False, True])
@pytest.mark.parametrize('h0', [False, True])
@pytest.mark.parametrize('act', ['tanh', 'relu'])
def test_gru(reverse, h0, act):
    rng = np.random.RandomState(14)
    ins = {'Input': [_seq_data(rng, 3 * D)],
           'Weight': [rng.randn(D, 3 * D).astype('float32') * 0.5],
           'Bias': [rng.randn(1, 3 * D).astype('float32') * 0.5]}
    if h0:
        ins['H0'] = [rng.randn(B, D).astype('float32')]
    check('gru', ins, {'is_reverse': reverse, 'gate_activation': 'sigmoid',
                       'activation': act}, ['Hidden'], 'Hidden')


@pytest.mark.parametrize('acts', [('tanh', 'sigmoid'), (2, 1), (3, 1),
                                  (0, 1)])
@pytest.mark.parametrize('slot', ['Hidden', 'ResetHiddenPrev', 'Gate'])
def test_gru_unit(acts, slot):
    rng = np.random.RandomState(15)
    ins = {'Input': [rng.randn(B, 3 * D).astype('float32')],
           'HiddenPrev': [rng.randn(B, D).astype('float32')],
           'Weight': [rng.randn(D, 3 * D).astype('float32') * 0.5],
           'Bias': [rng.randn(1, 3 * D).astype('float32')]}
    check('gru_unit', ins, {'activation': acts[0],
                            'gate_activation': acts[1]},
          ['Hidden', 'ResetHiddenPrev', 'Gate'], slot)


@pytest.mark.parametrize('slot', ['H', 'C'])
def test_lstm_unit(slot):
    rng = np.random.RandomState(16)
    ins = {'X': [rng.randn(B, 4 * D).astype('float32')],
           'C_prev': [rng.randn(B, D).astype('float32')]}
    check('lstm_unit', ins, {'forget_bias': 0.5}, ['H', 'C'], slot)


def test_attention_lstm_decoder_with_a_masked_encoder_row():
    """The second encoder row has no valid step: its attention is uniform
    over the padded axis in both packages."""
    rng = np.random.RandomState(17)
    E, Denc, H, S = 3, 4, 2, 6
    ins = {'TrgEmb': [_seq_data(rng, E)],
           'EncOut': [_seq_data(rng, Denc, t=S, lengths=[2, 0, 6, 3])],
           'WDec': [rng.randn(E + Denc, 4 * H).astype('float32') * 0.5],
           'UDec': [rng.randn(H, 4 * H).astype('float32') * 0.5],
           'BDec': [rng.randn(1, 4 * H).astype('float32') * 0.5],
           'WAttnQ': [rng.randn(H, Denc).astype('float32') * 0.5]}
    check('attention_lstm_decoder', ins, {}, ['Hidden'], 'Hidden')


# -- extra_ops' sequence rules and im2sequence ---------------------------------

def test_sequence_concat():
    rng = np.random.RandomState(18)
    a = _seq_data(rng, 2)
    b = _seq_data(rng, 2, t=3, lengths=[1, 3, 0, 2])
    check('sequence_concat', {'X': [a, b]}, {}, ['Out'], 'Out')


def test_sequence_slice():
    rng = np.random.RandomState(19)
    x = _seq_data(rng, 2)
    check('sequence_slice', {'X': [x],
                             'Offset': [np.array([[1], [0], [2], [0]],
                                                 'int64')],
                             'Length': [np.array([[2], [0], [3], [1]],
                                                 'int64')]},
          {}, ['Out'], 'Out')


def test_sequence_erase():
    rng = np.random.RandomState(20)
    ids = rng.randint(0, 5, (B, T, 1)).astype('int64')
    x = Seq(ids)
    for i, n in enumerate(LENS):
        x.data[i, n:] = 0
    check('sequence_erase', {'X': [x]}, {'tokens': [2, 4]}, ['Out'])


@pytest.mark.parametrize('kernels,strides,paddings', [
    ([2, 2], [1, 1], [0, 0, 0, 0]), ([3, 2], [2, 1], [1, 0, 2, 1])])
def test_im2sequence(kernels, strides, paddings):
    x = np.random.RandomState(21).randn(2, 3, 5, 6).astype('float32')
    check('im2sequence', {'X': [x]}, {'kernels': kernels,
                                      'strides': strides,
                                      'paddings': paddings}, ['Out'], 'Out')


# -- shape inference on meta tensors ---------------------------------------

def test_every_rule_runs_on_meta_tensors():
    """Build-time inference: a recurrence over the dynamic time axis runs
    one step and repeats it; no rule reads a length on the host."""
    from paddle_tpu_torch.fluid.framework import DYN_DIM

    def seq(*trail):
        return tlow.SeqValue(torch.empty((DYN_DIM, DYN_DIM) + trail,
                                         device='meta'),
                             torch.empty((DYN_DIM,), dtype=torch.int64,
                                         device='meta'))

    def meta(*shape):
        return torch.empty(shape, device='meta')

    ctx = tlow.Ctx(torch.device('meta'))
    cases = [
        ('lstm', {'Input': [seq(12)], 'Weight': [meta(3, 12)],
                  'Bias': [meta(1, 21)]}, {}, 'Hidden', (12 // 4,)),
        ('gru', {'Input': [seq(9)], 'Weight': [meta(3, 9)],
                 'Bias': [meta(1, 9)]}, {}, 'Hidden', (3,)),
        ('attention_lstm_decoder',
         {'TrgEmb': [seq(3)], 'EncOut': [seq(4)], 'WDec': [meta(7, 8)],
          'UDec': [meta(2, 8)], 'BDec': [meta(1, 8)],
          'WAttnQ': [meta(2, 4)]}, {}, 'Hidden', (2,)),
        ('sequence_conv', {'X': [seq(3)], 'Filter': [meta(9, 4)]},
         {'contextLength': 3}, 'Out', (4,)),
        ('sequence_reshape', {'X': [seq(6)]}, {'new_dim': 4}, 'Out', (4,)),
        ('sequence_concat', {'X': [seq(2), seq(2)]}, {}, 'Out', (2,)),
    ]
    for op_type, ins, attrs, slot, trail in cases:
        out = tlow.get_rule(op_type)(ins, attrs, ctx)[slot]
        assert isinstance(out, tlow.SeqValue), op_type
        assert out.data.shape[0] == DYN_DIM, op_type
        assert out.data.shape[1] % DYN_DIM == 0, op_type
        assert tuple(out.data.shape[2:]) == trail, op_type
