"""The port's sparse embedding gradient path (is_sparse=True), on the CPU:
the counterparts of tests/test_sparse_embedding.py, then the same programs
in both packages.

  * sparse SGD and sparse Adagrad give what the dense path gives, with
    duplicate ids in the batch (dense Adagrad leaves untouched rows
    unchanged, so the two are one function);
  * sparse Adam is lazy: untouched rows keep their params and moments;
  * fetching W@GRAD forces the dense path;
  * two lookups of one table share one plan entry;
  * the same programs through both packages from the JAX startup scope:
    losses and tables over 3 steps, the JAX run once with its Pallas
    kernels off and once with kernels.configure(['sparse_adam',
    'sparse_adagrad']) (interpret mode on the CPU), at 1e-5;
  * the scope holds the table updated in place after run, and a numpy
    fetch of it taken before the step keeps its value.
"""
import numpy as np
import pytest

import jax  # noqa: F401  (conftest pins it to the CPU)

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import framework as jframework
from paddle_tpu.fluid import unique_name as junique
from paddle_tpu.fluid.executor import Scope as JScope
from paddle_tpu.ops import kernels as jkernels

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import framework as tframework
from paddle_tpu_torch.fluid import unique_name as tunique

VOCAB, DIM = 50, 8
JAX = (jfluid, jframework, junique)
PORT = (tfluid, tframework, tunique)


def _default_model(fluid, is_sparse):
    """ids -> embedding(is_sparse) -> fc -> mean((pred - 1)^2)."""
    layers = fluid.layers
    ids = layers.data(name='ids', shape=[4, 1], dtype='int64')
    emb = layers.embedding(ids, size=[VOCAB, DIM], is_sparse=is_sparse,
                           param_attr=fluid.ParamAttr(name='emb_w'))
    pred = layers.fc(input=emb, size=1, num_flatten_dims=2,
                     bias_attr=False,
                     param_attr=fluid.ParamAttr(name='fc_w'))
    return layers.mean(layers.square(pred - 1.0)), 'emb_w'


def _shared_model(fluid, is_sparse):
    """One table read by two is_sparse lookups (a tied embedding)."""
    layers = fluid.layers
    a = layers.data(name='a', shape=[3, 1], dtype='int64')
    b = layers.data(name='b', shape=[2, 1], dtype='int64')
    ea = layers.embedding(a, size=[VOCAB, DIM], is_sparse=is_sparse,
                          param_attr=fluid.ParamAttr(name='shared_w'))
    eb = layers.embedding(b, size=[VOCAB, DIM], is_sparse=is_sparse,
                          param_attr=fluid.ParamAttr(name='shared_w'))
    pa = layers.fc(input=ea, size=1, num_flatten_dims=2, bias_attr=False,
                   param_attr=fluid.ParamAttr(name='fa'))
    pb = layers.fc(input=eb, size=1, num_flatten_dims=2, bias_attr=False,
                   param_attr=fluid.ParamAttr(name='fb'))
    loss = layers.mean(layers.square(pa - 1.0)) + \
        layers.mean(layers.square(pb + 1.0))
    return loss, 'shared_w'


OPTS = {
    'sgd': lambda fluid: fluid.optimizer.SGD(learning_rate=0.1),
    'adagrad': lambda fluid: fluid.optimizer.Adagrad(learning_rate=0.1),
    'adam': lambda fluid: fluid.optimizer.Adam(learning_rate=0.01),
}


def _build(pkg, opt, is_sparse, model=_default_model, seed=7):
    fluid, framework, unique_name = pkg
    main, startup = framework.Program(), framework.Program()
    main.random_seed = startup.random_seed = seed
    with unique_name.guard(), framework.program_guard(main, startup):
        loss, table = model(fluid, is_sparse)
        OPTS[opt](fluid).minimize(loss)
    return main, startup, loss.name, table


def _run_port(opt, is_sparse, batches, model=_default_model, init=None,
              fetch_grad=False):
    """Train with the port on the CPU; returns (losses, scope, plans)."""
    main, startup, loss, table = _build(PORT, opt, is_sparse, model)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    if init is None:
        exe.run(startup, scope=scope)
    else:
        scope.load_numpy(init, tfluid.CPUPlace())
    fetch = [loss] + (['%s@GRAD' % table] if fetch_grad else [])
    losses = []
    for b in batches:
        feed = b if isinstance(b, dict) else {'ids': b}
        out = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
        losses.append(float(out[0][0]))
    plans = [p.sparse_plan for p in exe._cache.values()]
    return losses, scope, plans


def _batches(seed=3, n=3, dup=False):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        b = rng.randint(0, VOCAB, size=(6, 4, 1)).astype('int64')
        if dup:
            b[:3] = b[3:6]  # force duplicate ids within the batch
        out.append(b)
    return out


@pytest.mark.parametrize('opt', ['sgd', 'adagrad'])
def test_sparse_matches_dense(opt):
    """SGD is linear in the gradient, and dense Adagrad leaves untouched
    rows exactly unchanged (g=0: m += 0, p -= 0), so the touched-rows
    update agrees with dense everywhere, duplicates merged first."""
    batches = _batches(dup=True)
    dl, dscope, dplans = _run_port(opt, False, batches)
    sl, sscope, splans = _run_port(opt, True, batches)
    assert any(splans) and not any(dplans)
    np.testing.assert_allclose(sl, dl, rtol=1e-5)
    np.testing.assert_allclose(sscope.to_numpy(['emb_w'])['emb_w'],
                               dscope.to_numpy(['emb_w'])['emb_w'],
                               rtol=1e-4, atol=1e-6)


def test_sparse_adam_is_lazy():
    """Rows the batches do not touch keep their params AND moments (dense
    adam decays every row's moments each step)."""
    b1 = np.array([0, 1, 2, 3] * 6).reshape(6, 4, 1).astype('int64')
    b2 = np.array([4, 5, 6, 7] * 6).reshape(6, 4, 1).astype('int64')
    _, scope0, _ = _run_port('adam', True, [])
    _, scope, plans = _run_port('adam', True, [b1, b2])
    assert any(plans)
    table0 = scope0.to_numpy(['emb_w'])['emb_w']
    state = scope.to_numpy()
    np.testing.assert_array_equal(state['emb_w'][8:], table0[8:])
    assert np.abs(state['emb_w'][:8] - table0[:8]).max() > 0
    m1 = next(v for n, v in state.items()
              if n.startswith('moment1') and v.shape == (VOCAB, DIM))
    assert np.abs(m1[:4]).max() > 0
    assert np.abs(m1[8:]).max() == 0      # untouched: moments never built


def test_fetching_the_table_gradient_forces_the_dense_path():
    losses, _, plans = _run_port('sgd', True, _batches(n=1),
                                 fetch_grad=True)
    assert not any(plans) and np.isfinite(losses).all()


def test_two_lookups_of_one_table_share_one_plan_entry():
    rng = np.random.RandomState(5)
    batches = [{'a': rng.randint(0, VOCAB, size=(4, 3, 1)).astype('int64'),
                'b': rng.randint(0, VOCAB, size=(4, 2, 1)).astype('int64')}
               for _ in range(3)]
    dl, dscope, _ = _run_port('sgd', False, batches, model=_shared_model)
    sl, sscope, splans = _run_port('sgd', True, batches,
                                   model=_shared_model)
    plan = next(p for p in splans if p)
    assert list(plan) == ['shared_w'] and len(plan['shared_w']['lookups']) == 2
    np.testing.assert_allclose(sl, dl, rtol=1e-5)
    np.testing.assert_allclose(sscope.to_numpy(['shared_w'])['shared_w'],
                               dscope.to_numpy(['shared_w'])['shared_w'],
                               rtol=1e-4, atol=1e-6)


def test_the_scope_holds_the_table_updated_in_place():
    main, startup, loss, _ = _build(PORT, 'adam', True)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    table = scope.vars['emb_w']
    before, = exe.run(main, feed={'ids': _batches(n=1)[0]},
                      fetch_list=['emb_w'], scope=scope)
    snapshot = before.copy()
    exe.run(main, feed={'ids': _batches(seed=4, n=1)[0]}, fetch_list=[loss],
            scope=scope)
    after = scope.vars['emb_w']
    assert after.data_ptr() == table.data_ptr()
    assert not np.array_equal(after.numpy(), snapshot)
    np.testing.assert_array_equal(before, snapshot)


def _run_jax(opt, batches, model):
    main, startup, loss, table = _build(JAX, opt, True, model)
    scope = JScope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(startup)
        init = {n: np.array(v, copy=True) for n, v in scope.vars.items()}
        losses = []
        for b in batches:
            feed = b if isinstance(b, dict) else {'ids': b}
            losses.append(float(np.asarray(
                exe.run(main, feed=feed, fetch_list=[loss])[0]).reshape(-1)[0]))
        final = {n: np.array(v) for n, v in scope.vars.items()}
    assert any(c.sparse_plan for c in exe._cache.values())
    return init, losses, final


@pytest.mark.parametrize('kernels', ['off', 'pallas'])
@pytest.mark.parametrize('opt', ['sgd', 'adagrad', 'adam'])
def test_the_same_programs_in_both_packages(opt, kernels):
    batches = _batches(seed=11, dup=True)
    prev = jkernels.configure(
        False if kernels == 'off' else ['sparse_adam', 'sparse_adagrad'])
    try:
        init, jl, final = _run_jax(opt, batches, _default_model)
    finally:
        jkernels.configure(prev)
    tl, scope, plans = _run_port(opt, True, batches, init=init)
    assert any(plans)
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-5)
    got = scope.to_numpy(sorted(final))
    for n, want in final.items():
        np.testing.assert_allclose(got[n], want, rtol=1e-5, atol=1e-5,
                                   err_msg=n)
