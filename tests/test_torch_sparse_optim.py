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
    JAX rules handed the same SparseRows (their XLA branches), at 1e-6;
  * the rows form (fused_sparse_*_rows, the rules' path: the gradient as
    it comes, repeats summed inside): its plain version against the JAX
    merge followed by the Pallas kernel in interpret mode at 1e-6, and
    bitwise against the merged form's plain version after _merge_sparse;
    an fp32 emulation of the CUDA kernel's order of operations (the ids'
    int32 sort, segment heads, each segment summed in ascending sorted
    position from 0.0, the update's expression) bitwise equal to the
    plain rows form; sort_ids and launch_sorted on the CPU.
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


# -- the rows form ------------------------------------------------------------

def _rows_ids(kind, n):
    """'repeats': ids with repeats, 0 among them twice; 'single': one id
    repeated; 'one': C = 1."""
    if kind == 'repeats':
        return _ids(n, n)
    if kind == 'single':
        return np.full(n, 7, 'int64')
    return np.array([5], 'int64')


def _rows_case(seed, kind, D, n=30):
    """Ids, gradient rows at a training step's scale (a sum of 30 repeats
    stays below 1, so 1e-6 is a few ulps of every moment) and tables."""
    r = np.random.RandomState(seed)
    ids = _rows_ids(kind, n)
    rows = (r.randn(len(ids), D) * 0.05).astype('float32')
    tables = dict(p=(r.randn(V, D) * 0.5).astype('float32'),
                  m=np.abs(r.randn(V, D)).astype('float32'),
                  m1=(r.randn(V, D) * 0.1).astype('float32'),
                  m2=np.abs(r.randn(V, D) * 0.1).astype('float32'))
    return ids, rows, tables


_B1, _B2, _ADAM_EPS, _ADAGRAD_EPS = 0.9, 0.999, 1e-8, 1e-6
_LR = {'adagrad': np.float32(0.1),
       'adam': np.float32(1e-2 * np.sqrt(1 - _B2 ** 3) / (1 - _B1 ** 3))}
_NAMES = {'adagrad': ('p', 'm'), 'adam': ('p', 'm1', 'm2')}


def _rows_port(opt, ids, rows, tables, fn=None):
    """The port's rows form (or `fn`, same signature) on CPU tensors."""
    ts = [_t(tables[n]) for n in _NAMES[opt]]
    lr = torch.tensor(_LR[opt])
    if opt == 'adagrad':
        fn = fn or tkern.fused_sparse_adagrad_rows
        return fn(*ts, _t(ids), _t(rows), lr, _ADAGRAD_EPS)
    fn = fn or tkern.fused_sparse_adam_rows
    return fn(*ts, _t(ids), _t(rows), lr, _B1, _B2, _ADAM_EPS)


@pytest.mark.parametrize('kind', ['repeats', 'single', 'one'])
@pytest.mark.parametrize('D', [1, 4, 10])
@pytest.mark.parametrize('opt', ['adagrad', 'adam'])
def test_rows_form_matches_the_jax_merge_and_pallas_kernel(opt, D, kind):
    ids, rows, tb = _rows_case(40 + D, kind, D)
    uids, gm, valid = [jnp.asarray(a) for a in joptim._merge_sparse(
        jlow.SparseRows(jnp.asarray(ids.astype('int32')), jnp.asarray(rows),
                        (V, D)))]
    jt = [jnp.asarray(tb[n]) for n in _NAMES[opt]]
    if opt == 'adagrad':
        want = jkern.fused_sparse_adagrad(*jt, uids, gm, valid, _LR[opt],
                                          _ADAGRAD_EPS, interpret=True)
    else:
        want = jkern.fused_sparse_adam(*jt, uids, gm, valid, _LR[opt], _B1,
                                       _B2, _ADAM_EPS, interpret=True)
    got = _rows_port(opt, ids, rows, tb)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=TOL)
    touched = sorted(set(ids.tolist()))
    untouched = sorted(set(range(V)) - set(touched))
    for g, n in zip(got, _NAMES[opt]):
        assert not np.array_equal(g.numpy()[touched], tb[n][touched])
        np.testing.assert_array_equal(g.numpy()[untouched],
                                      tb[n][untouched])


@pytest.mark.parametrize('kind', ['repeats', 'single', 'one'])
@pytest.mark.parametrize('opt', ['adagrad', 'adam'])
def test_rows_form_is_the_merged_form_after_the_merge(opt, kind):
    ids, rows, tb = _rows_case(50, kind, 6)
    got = _rows_port(opt, ids, rows, tb)
    uids, gm, valid = toptim._merge_sparse(tlow.SparseRows(
        _t(ids), _t(rows), (V, 6)))
    ts = [_t(tb[n]) for n in _NAMES[opt]]
    lr = torch.tensor(_LR[opt])
    if opt == 'adagrad':
        want = tkern.fused_sparse_adagrad(*ts, uids, gm, valid, lr,
                                          _ADAGRAD_EPS)
    else:
        want = tkern.fused_sparse_adam(*ts, uids, gm, valid, lr, _B1, _B2,
                                       _ADAM_EPS)
    for g, w in zip(got, want):
        assert g.numpy().tobytes() == w.numpy().tobytes()


def _kernel_emulation(opt, ids, rows, tables):
    """The CUDA rows-form kernel's arithmetic in numpy fp32, in its order:
    the ids sorted stably as int32; position i heads a segment when its id
    differs from position i-1's; the head sums rows[order[j]] for j = i,
    i+1, ... while the id holds, from 0.0, one fp32 add at a time (the
    head thread's adds for a segment inside its window of 8 positions,
    one thread a column of its block for a longer one: the same order);
    then the update's expression, one rounded operation at a time, on the
    head's table row. The square root is torch's on the CPU, as the plain
    version's: the kernel's __fsqrt_rn is correctly rounded, torch's
    vectorised CPU sqrt not always (it differs from numpy's in the last
    bit for some 0.6% of inputs)."""
    f = np.float32

    def sqrt(x):
        return torch.sqrt(torch.from_numpy(x)).numpy()
    sids = ids.astype('int32')
    order = np.argsort(sids, kind='stable')
    sids = sids[order]
    out = {n: tables[n].copy() for n in _NAMES[opt]}
    lr = f(_LR[opt])
    for i in range(len(sids)):
        if i > 0 and sids[i - 1] == sids[i]:
            continue
        u = sids[i]
        g = np.zeros(rows.shape[1], 'float32')
        for j in range(i, len(sids)):
            if sids[j] != u:
                break
            g = g + rows[order[j]]
        if opt == 'adagrad':
            pv, mv = out['p'][u].copy(), out['m'][u].copy()
            m_new = mv + g * g
            delta = (-lr * g) / (sqrt(m_new) + f(_ADAGRAD_EPS))
            out['p'][u] = pv + delta
            out['m'][u] = mv + (m_new - mv)
        else:
            pv, a, b = (out[n][u].copy() for n in ('p', 'm1', 'm2'))
            a_new = f(_B1) * a + f(1 - _B1) * g
            b_new = f(_B2) * b + (f(1 - _B2) * g) * g
            delta = (-lr * a_new) / (sqrt(b_new) + f(_ADAM_EPS))
            out['p'][u] = pv + delta
            out['m1'][u] = a + (a_new - a)
            out['m2'][u] = b + (b_new - b)
    return [out[n] for n in _NAMES[opt]]


@pytest.mark.parametrize('kind', ['repeats', 'single', 'one', 'wide'])
@pytest.mark.parametrize('D', [1, 4, 10])
@pytest.mark.parametrize('opt', ['adagrad', 'adam'])
def test_kernel_order_emulation_is_the_plain_rows_form_bitwise(opt, D,
                                                                kind):
    """What the card computes, emulated, is bitwise the CPU's plain route:
    the CUDA kernel sums each segment in the order index_add_ does on the
    CPU. 'wide': 200 ids over 24 rows, segments around the window's 8
    positions."""
    n = 200 if kind == 'wide' else 30
    ids, rows, tb = _rows_case(60 + D, 'repeats' if kind == 'wide' else kind,
                               D, n)
    want = _kernel_emulation(opt, ids, rows, tb)
    got = _rows_port(opt, ids, rows, tb)
    for g, w in zip(got, want):
        assert g.numpy().tobytes() == w.tobytes()


@pytest.mark.parametrize('kind', ['repeats', 'single', 'one'])
def test_sort_ids_is_the_plans_order(kind):
    ids = _rows_ids(kind, 40)
    sids, order = tkern.sparse_optim.sort_ids(_t(ids), V)
    assert sids.dtype == torch.int32 and order.dtype == torch.int64
    _, _, plan_order, _ = tlookup.dedup_plan(_t(ids))
    np.testing.assert_array_equal(order.numpy(), plan_order.numpy())
    np.testing.assert_array_equal(sids.numpy(), np.sort(ids))
    # a vocabulary past int32 keeps the int64 ids
    wide, _ = tkern.sparse_optim.sort_ids(_t(ids), 2 ** 31)
    assert wide.dtype == torch.int64


def test_launch_sorted_refuses_cpu_tensors():
    ids, rows, tb = _rows_case(3, 'repeats', 4)
    sids, order = tkern.sparse_optim.sort_ids(_t(ids), V)
    with pytest.raises(ValueError, match='card'):
        tkern.sparse_optim.launch_sorted(
            [_t(tb['p']), _t(tb['m'])], sids, order, _t(rows),
            torch.tensor(0.1), 1e-6)


@pytest.mark.parametrize('kind', ['single', 'one'])
@pytest.mark.parametrize('op_type', ['adagrad', 'adam'])
def test_sparse_rule_branches_match_the_jax_rules_on_edge_ids(op_type, kind):
    r = np.random.RandomState(4)
    D = 3
    ids = _rows_ids(kind, 12)
    rows = (r.randn(len(ids), D) * 0.3).astype('float32')
    ins = {'Param': (r.randn(V, D) * 0.5).astype('float32'),
           'LearningRate': np.array([0.05], 'float32')}
    if op_type == 'adagrad':
        ins['Moment'] = np.abs(r.randn(V, D)).astype('float32')
        attrs, slots = {'epsilon': 1e-6}, ('ParamOut', 'MomentOut')
    else:
        ins.update(Moment1=(r.randn(V, D) * 0.1).astype('float32'),
                   Moment2=np.abs(r.randn(V, D) * 0.1).astype('float32'),
                   Beta1Pow=np.array([0.9 ** 2], 'float32'),
                   Beta2Pow=np.array([0.999 ** 2], 'float32'))
        attrs = {'beta1': 0.9, 'beta2': 0.999, 'epsilon': 1e-8}
        slots = ('ParamOut', 'Moment1Out', 'Moment2Out')
    _rule_both(op_type, ins, (ids, rows), attrs, slots)
