"""The port's fused sparse optimizer updates and their merge against the JAX
package's, on the CPU, on the same numpy inputs:

  * the port's dedup_plan and _merge_sparse against the JAX ones: uids,
    seg, order, the unique count and valid exactly, merged rows at 1e-6;
  * the plain fused_sparse_adagrad / fused_sparse_adam (what the CUDA
    kernels compute, ops/kernels/sparse_optim.py) against the JAX Pallas
    kernels run in interpret mode, at 1e-6 (the Pallas kernel test's
    tolerance, tests/test_kernels.py:182), on merges whose ids repeat and
    include id 0, so a valid row 0 shares its row with the clamped
    invalid slots;
  * an all-invalid merge leaves the tables bitwise unchanged, -0.0
    entries included;
  * the in-place contract: the wrapper returns the very tensors it was
    given, updated;
  * the sparse branches of the sgd, adagrad and adam rules against the
    JAX rules handed the same SparseRows (their XLA branches), at 1e-6.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu.fluid  # noqa: F401  (registers the JAX rules)
from paddle_tpu.embedding import lookup as jlookup
from paddle_tpu.fluid import lowering as jlow
from paddle_tpu.fluid.ops_impl import optim_ops as joptim
from paddle_tpu.ops.kernels import sparse_optim as jkern

import paddle_tpu_torch.fluid  # noqa: F401  (registers the port's rules)
from paddle_tpu_torch.embedding import lookup as tlookup
from paddle_tpu_torch.fluid import lowering as tlow
from paddle_tpu_torch.fluid.ops_impl import optim_ops as toptim
from paddle_tpu_torch.ops import kernels as tkern

TOL = 1e-6
V = 24


def _ids(seed, n, high=V):
    """n ids with repeats, 0 among them twice."""
    r = np.random.RandomState(seed)
    ids = r.randint(0, high, n).astype('int64')
    ids[[1, n - 2]] = 0
    return ids


def _merge_both(ids, rows):
    jm = joptim._merge_sparse(jlow.SparseRows(
        jnp.asarray(ids.astype('int32')), jnp.asarray(rows),
        (V, rows.shape[1])))
    tm = toptim._merge_sparse(tlow.SparseRows(
        torch.from_numpy(ids), torch.from_numpy(rows), (V, rows.shape[1])))
    return [np.asarray(a) for a in jm], [t.numpy() for t in tm]


@pytest.mark.parametrize('n,high', [(17, V), (40, 6), (1, V)])
def test_dedup_plan_is_the_jax_plan(n, high):
    ids = _ids(n, n, high) if n > 2 else np.zeros(n, 'int64')
    j = jlookup.dedup_plan(jnp.asarray(ids.astype('int32')))
    t = tlookup.dedup_plan(torch.from_numpy(ids))
    for name, a, b in zip(('uids', 'seg', 'order', 'n_unique'), j, t):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                      err_msg=name)


@pytest.mark.parametrize('D', [1, 4, 10])
def test_merge_sparse_is_the_jax_merge(D):
    ids = _ids(D, 30)
    rows = np.random.RandomState(D).randn(30, D).astype('float32')
    (ju, jg, jv), (tu, tg, tv) = _merge_both(ids, rows)
    np.testing.assert_array_equal(tu, ju)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_allclose(tg, jg, rtol=TOL, atol=TOL)
    n_unique = len(set(ids.tolist()))
    assert tv.sum() == n_unique and (tu[n_unique:] == 0).all()
    assert (tg[n_unique:] == 0).all()


def _case(seed, D, n=30):
    """A merge with repeats and a valid id 0, and moment tables."""
    r = np.random.RandomState(seed)
    ids = _ids(seed, n)
    rows = (r.randn(n, D) * 0.3).astype('float32')
    (uids, gm, valid), _ = _merge_both(ids, rows)
    assert uids[0] == 0 and valid[0] and not valid[-1]
    tables = dict(p=(r.randn(V, D) * 0.5).astype('float32'),
                  m=np.abs(r.randn(V, D)).astype('float32'),
                  m1=(r.randn(V, D) * 0.1).astype('float32'),
                  m2=np.abs(r.randn(V, D) * 0.1).astype('float32'))
    return uids, gm, valid, tables


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.mark.parametrize('D', [1, 4, 10])
def test_plain_adagrad_matches_the_pallas_kernel(D):
    uids, gm, valid, tb = _case(10 + D, D)
    lr, eps = 0.1, 1e-6
    want = jkern.fused_sparse_adagrad(
        jnp.asarray(tb['p']), jnp.asarray(tb['m']), jnp.asarray(uids),
        jnp.asarray(gm), jnp.asarray(valid), lr, eps, interpret=True)
    got = tkern.fused_sparse_adagrad(
        _t(tb['p']), _t(tb['m']), _t(uids).long(), _t(gm), _t(valid),
        torch.tensor(lr, dtype=torch.float32), eps)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=TOL)
    assert not np.array_equal(got[0].numpy(), tb['p'])


@pytest.mark.parametrize('D', [1, 4, 10])
def test_plain_adam_matches_the_pallas_kernel(D):
    uids, gm, valid, tb = _case(20 + D, D)
    b1, b2, eps = 0.9, 0.999, 1e-8
    lr = np.float32(1e-2 * np.sqrt(1 - b2 ** 3) / (1 - b1 ** 3))
    want = jkern.fused_sparse_adam(
        jnp.asarray(tb['p']), jnp.asarray(tb['m1']), jnp.asarray(tb['m2']),
        jnp.asarray(uids), jnp.asarray(gm), jnp.asarray(valid), lr, b1, b2,
        eps, interpret=True)
    got = tkern.fused_sparse_adam(
        _t(tb['p']), _t(tb['m1']), _t(tb['m2']), _t(uids).long(), _t(gm),
        _t(valid), torch.tensor(lr), b1, b2, eps)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=TOL)
    # untouched rows keep their values and moments (lazy adam)
    untouched = sorted(set(range(V)) - set(uids[valid].tolist()))
    assert untouched
    for g, a in zip(got, (tb['p'], tb['m1'], tb['m2'])):
        np.testing.assert_array_equal(g.numpy()[untouched], a[untouched])


@pytest.mark.parametrize('opt', ['adagrad', 'adam'])
def test_all_invalid_merge_is_a_bitwise_no_op(opt):
    r = np.random.RandomState(5)
    tables = [(r.randn(10, 6) * 0.5).astype('float32') for _ in range(3)]
    for t in tables:
        t[0, :3] = -0.0                 # signed zeros survive too
    before = [t.copy() for t in tables]
    uids = torch.zeros(4, dtype=torch.int64)
    valid = torch.zeros(4, dtype=torch.bool)
    gm = torch.zeros((4, 6))
    ts = [_t(t) for t in tables]
    lr = torch.tensor(0.1)
    if opt == 'adagrad':
        out = tkern.fused_sparse_adagrad(ts[0], ts[1], uids, gm, valid, lr,
                                         1e-6)
    else:
        out = tkern.fused_sparse_adam(*ts, uids, gm, valid, lr, 0.9, 0.999,
                                      1e-8)
    for o, b in zip(out, before):
        assert o.numpy().tobytes() == b.tobytes()


@pytest.mark.parametrize('opt', ['adagrad', 'adam'])
def test_the_update_is_in_place(opt):
    uids, gm, valid, tb = _case(7, 4)
    names = ('p', 'm') if opt == 'adagrad' else ('p', 'm1', 'm2')
    ts = [_t(tb[n]) for n in names]
    ptrs = [t.data_ptr() for t in ts]
    args = (_t(uids).long(), _t(gm), _t(valid), torch.tensor(0.05))
    if opt == 'adagrad':
        out = tkern.fused_sparse_adagrad(*ts, *args, 1e-6)
    else:
        out = tkern.fused_sparse_adam(*ts, *args, 0.9, 0.999, 1e-8)
    assert all(o is t for o, t in zip(out, ts))
    assert [t.data_ptr() for t in ts] == ptrs
    assert not np.array_equal(ts[0].numpy(), tb['p'])


def _rule_both(op_type, ins, sparse, attrs, slots):
    """Run the JAX and the port rule on the same inputs, the Grad slot a
    SparseRows (ids, rows) of the Param's shape; compare `slots`."""
    ids, rows = sparse
    shape = ins['Param'].shape
    jins = {k: [jnp.asarray(v)] for k, v in ins.items()}
    jins['Grad'] = [jlow.SparseRows(jnp.asarray(ids.astype('int32')),
                                    jnp.asarray(rows), shape)]
    jouts = jlow.get_rule(op_type)(jins, attrs,
                                   jlow.Ctx(jax.random.key(0)))
    tins = {k: [_t(v)] for k, v in ins.items()}
    tins['Grad'] = [tlow.SparseRows(_t(ids), _t(rows), shape)]
    touts = tlow.get_rule(op_type)(tins, attrs,
                                   tlow.Ctx(torch.device('cpu')))
    for s in slots:
        np.testing.assert_allclose(touts[s].numpy(), np.asarray(jouts[s]),
                                   rtol=TOL, atol=TOL, err_msg=s)
    return touts


@pytest.mark.parametrize('op_type', ['sgd', 'adagrad', 'adam'])
def test_sparse_rule_branches_match_the_jax_rules(op_type):
    r = np.random.RandomState(3)
    D = 5
    ids = _ids(3, 20)
    rows = (r.randn(20, D) * 0.3).astype('float32')
    ins = {'Param': (r.randn(V, D) * 0.5).astype('float32'),
           'LearningRate': np.array([0.05], 'float32')}
    attrs, slots = {}, ('ParamOut',)
    if op_type == 'adagrad':
        ins['Moment'] = np.abs(r.randn(V, D)).astype('float32')
        attrs, slots = {'epsilon': 1e-6}, ('ParamOut', 'MomentOut')
    elif op_type == 'adam':
        ins.update(Moment1=(r.randn(V, D) * 0.1).astype('float32'),
                   Moment2=np.abs(r.randn(V, D) * 0.1).astype('float32'),
                   Beta1Pow=np.array([0.9 ** 3], 'float32'),
                   Beta2Pow=np.array([0.999 ** 3], 'float32'))
        attrs = {'beta1': 0.9, 'beta2': 0.999, 'epsilon': 1e-8}
        slots = ('ParamOut', 'Moment1Out', 'Moment2Out')
    _rule_both(op_type, ins, (ids, rows), attrs, slots)


def test_sparse_rows_to_dense_is_the_jax_one():
    ids = _ids(9, 12)
    rows = np.random.RandomState(9).randn(12, 3).astype('float32')
    j = jlow.SparseRows(jnp.asarray(ids.astype('int32')),
                        jnp.asarray(rows), (V, 3))
    t = tlow.SparseRows(_t(ids), _t(rows), (V, 3))
    np.testing.assert_allclose(t.to_dense().numpy(), np.asarray(j.to_dense()),
                               rtol=TOL, atol=TOL)
    assert t.astype(torch.float64).dtype == torch.float64
    assert t.astype(torch.float64).dense_shape == (V, 3)
