"""The port's mixture of experts against the JAX package's, on the CPU.

In one process, on the same numpy inputs:
  * router_topk, load_balancing_loss (and its gradient), pack_topk and
    combine_topk at top 1 and 2, with and without overflow, against the
    JAX functions (1e-6; the routing, slots and drops exactly);
  * the moe_mlp rule through a program (the dense path): Out, AuxLoss and
    the five parameters' gradients under a random cotangent, at top 1 and
    2, three activations, 2-D and 3-D input, with and without overflow,
    against the JAX program from the same weights (1e-5 of each tensor's
    largest magnitude);
  * layers.moe_mlp's validation (a bad act, top_k out of range) with the
    JAX messages, and its five parameters carried across by name through
    the __params__.npz path in both directions.

On 2 and 4 gloo ranks (tests/torch_mesh_cases.py, one spawn per world, each
joined within 120 s): the functional moe_apply against the JAX moe_apply on
an ep mesh of as many devices, and training through the moe_mlp rule held
within rtol 2e-5 of the JAX dp mesh: the mesh path with 1, 2 and 4 experts
per rank, under overflow (its drops are per rank, as the JAX mesh path's),
and with 3 experts, which no dp of 2 or 4 divides (the dense path on the
global tokens). The auxiliary loss is the global batch's: equal to the
single-device one at step 1.
"""
import os
import pickle

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import paddle_tpu.fluid as jfluid
from paddle_tpu import parallel as jparallel
from paddle_tpu.fluid import framework as jframework
from paddle_tpu.fluid import io as jio
from paddle_tpu.parallel import moe as jmoe

import torch

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import framework as tframework
from paddle_tpu_torch.fluid import io as tio
from paddle_tpu_torch.parallel import moe as tmoe

import torch_mesh_cases as C

RTOL = 2e-5


def _logits(nt, e, seed, ties=False):
    rng = np.random.RandomState(seed)
    z = rng.randn(nt, e).astype('float32')
    if ties:
        z[::3, 1] = z[::3, 0]          # exact ties: the lower index first
    return z


@pytest.mark.parametrize('top_k', [1, 2])
@pytest.mark.parametrize('ties', [False, True])
def test_router_topk_like_jax(top_k, ties):
    z = _logits(48, 6, 1, ties)
    je, jg = jmoe.router_topk(jnp.asarray(z), top_k)
    te, tg = tmoe.router_topk(torch.from_numpy(z), top_k)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize('top_k', [1, 2])
def test_load_balancing_loss_and_gradient_like_jax(top_k):
    z = _logits(64, 8, 2)
    jl, jgrad = jax.value_and_grad(
        lambda v: jmoe.load_balancing_loss(v, top_k))(jnp.asarray(z))
    t = torch.from_numpy(z).requires_grad_()
    tl = tmoe.load_balancing_loss(t, top_k)
    tgrad, = torch.autograd.grad(tl, [t])
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize('top_k', [1, 2])
@pytest.mark.parametrize('cap', [12, 3])
def test_pack_and_combine_like_jax(top_k, cap):
    """cap 12 holds every token; cap 3 drops (first choices claim slots
    before second choices, then token order)."""
    rng = np.random.RandomState(3)
    x = rng.randn(40, 5).astype('float32')
    z = _logits(40, 4, 4, ties=True)
    js, jr = jmoe.pack_topk(jnp.asarray(x), jnp.asarray(z), 4, cap, top_k)
    ts, tr = tmoe.pack_topk(torch.from_numpy(x), torch.from_numpy(z), 4, cap,
                            top_k)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # expert, slot and keep exactly; the renormalized gate to an ulp
    for a, b in zip(tr[:3], jr[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(tr[3].numpy(), np.asarray(jr[3]), rtol=1e-6)
    if cap == 3:
        assert not bool(tr[2].all())
    back = rng.randn(4, cap, 7).astype('float32')
    jy = jmoe.combine_topk(jnp.asarray(back), jr, jnp.float32)
    ty = tmoe.combine_topk(torch.from_numpy(back), tr, torch.float32)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-6,
                               atol=1e-7)
    if top_k == 1:
        j1s, j1r = jmoe.pack_top1(jnp.asarray(x), jnp.asarray(z), 4, cap)
        t1s, t1r = tmoe.pack_top1(torch.from_numpy(x), torch.from_numpy(z),
                                  4, cap)
        np.testing.assert_array_equal(t1s.numpy(), np.asarray(j1s))
        np.testing.assert_allclose(
            tmoe.combine_top1(torch.from_numpy(back), t1r,
                              torch.float32).numpy(),
            np.asarray(jmoe.combine_top1(jnp.asarray(back), j1r,
                                         jnp.float32)), rtol=1e-6)


def _rule_program(fluid, framework, shape, n_exp, top_k, act, cf):
    main, startup = framework.Program(), framework.Program()
    with fluid.unique_name.guard(), framework.program_guard(main, startup):
        x = fluid.layers.data(name='x', shape=shape[1:], dtype='float32')
        c = fluid.layers.data(name='c', shape=shape[1:-1] + [6],
                              dtype='float32')
        out, aux = fluid.layers.moe_mlp(
            x, num_experts=n_exp, hidden_size=12, size=6, act=act,
            capacity_factor=cf, top_k=top_k, return_aux_loss=True)
        loss = fluid.layers.elementwise_add(
            fluid.layers.reduce_sum(fluid.layers.elementwise_mul(out, c)),
            fluid.layers.scale(aux, scale=0.5))
        fluid.backward.append_backward(loss)
    return main, startup, out.name, aux.name, loss.name


@pytest.mark.parametrize('shape,n_exp,top_k,act,cf', [
    ([24, 8], 4, 1, 'relu', 2.0),
    ([24, 8], 4, 2, 'gelu', 2.0),
    ([6, 4, 8], 3, 2, 'swish', 2.0),      # 3-D input
    ([24, 8], 4, 2, 'tanh', 0.5),         # overflow
    ([6, 4, 8], 4, 1, None, 0.5),         # 3-D, overflow, no activation
])
def test_moe_mlp_forward_and_vjp_like_jax(shape, n_exp, top_k, act, cf):
    rng = np.random.RandomState(5)
    feed = {'x': rng.randn(*shape).astype('float32'),
            'c': rng.randn(*(shape[:-1] + [6])).astype('float32')}
    got = {}
    init = None
    for fluid, framework, pkg in ((jfluid, jframework, 'jax'),
                                  (tfluid, tframework, 'port')):
        main, startup, out, aux, loss = _rule_program(
            fluid, framework, shape, n_exp, top_k, act, cf)
        params = sorted(v.name for v in main.list_vars()
                        if isinstance(v, framework.Parameter))
        assert params == ['moe_mlp_0.b_0', 'moe_mlp_0.b_1', 'moe_mlp_0.w_0',
                          'moe_mlp_0.w_1', 'moe_mlp_0.w_2']
        exe = fluid.Executor(fluid.CPUPlace())
        if pkg == 'jax':
            from paddle_tpu.fluid.executor import Scope
            scope = Scope()
            with jfluid.scope_guard(scope):
                exe.run(startup)
            # perturb the biases off zero so their gradients matter
            init = {n: np.asarray(scope.vars[n]) + (
                rng.randn(*np.shape(scope.vars[n])).astype('float32') * 0.1
                if '.b_' in n else 0) for n in params}
            scope.vars.update({n: jnp.asarray(v) for n, v in init.items()})
        else:
            scope = tfluid.Scope()
            scope.load_numpy(init, tfluid.CPUPlace())
        fetch = [out, aux, loss] + [p + '@GRAD' for p in params]
        with fluid.scope_guard(scope):
            got[pkg] = [np.asarray(v) for v in exe.run(
                main, feed=feed, fetch_list=fetch)]
    assert got['port'][0].shape == tuple(shape[:-1]) + (6,)
    for i, (a, b) in enumerate(zip(got['port'], got['jax'])):
        np.testing.assert_allclose(
            a, b, rtol=1e-5, atol=1e-5 * float(np.max(np.abs(b)) + 1e-30),
            err_msg='fetch %d' % i)


def test_moe_mlp_validation_like_jax():
    for fluid, framework in ((jfluid, jframework), (tfluid, tframework)):
        msgs = []
        for kw in (dict(act='leaky'), dict(top_k=5), dict(top_k=0)):
            main, startup = framework.Program(), framework.Program()
            with framework.program_guard(main, startup):
                x = fluid.layers.data(name='x', shape=[8], dtype='float32')
                with pytest.raises(ValueError) as e:
                    fluid.layers.moe_mlp(x, num_experts=4, hidden_size=8,
                                         **kw)
                msgs.append(str(e.value))
        if fluid is jfluid:
            want = msgs
        else:
            assert msgs == want


@pytest.mark.parametrize('direction', ['jax_to_port', 'port_to_jax'])
def test_moe_weights_cross_packages_by_name(tmp_path, direction):
    """The five moe_mlp parameters through save_params / load_params: the
    other package loads them by name and computes the same forward."""
    rng = np.random.RandomState(9)
    feed = {'x': rng.randn(24, 8).astype('float32'),
            'c': rng.randn(24, 6).astype('float32')}
    pkgs = [(jfluid, jframework, jio), (tfluid, tframework, tio)]
    if direction == 'port_to_jax':
        pkgs.reverse()
    outs = []
    for i, (fluid, framework, io) in enumerate(pkgs):
        main, startup, out, aux, _ = _rule_program(
            fluid, framework, [24, 8], 4, 2, 'relu', 2.0)
        infer = main.clone(for_test=True)
        exe = fluid.Executor(fluid.CPUPlace())
        scope = tfluid.Scope() if fluid is tfluid else \
            __import__('paddle_tpu.fluid.executor',
                       fromlist=['Scope']).Scope()
        with fluid.scope_guard(scope):
            exe.run(startup)
            if i == 0:
                io.save_params(exe, str(tmp_path), main_program=main)
            else:
                io.load_params(exe, str(tmp_path), main_program=main)
            outs.append([np.asarray(v) for v in exe.run(
                infer, feed=feed, fetch_list=[out, aux])])
    assert sorted(os.listdir(str(tmp_path)))
    for a, b in zip(outs[1], outs[0]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


# -- on gloo ranks ------------------------------------------------------------

MOE_JOBS = [('moe_e4', 'mesh'), ('moe_e8', 'pe'), ('moe_e3', 'mesh'),
            ('moe_drop', 'mesh')]
APPLY = [(4, 1, 8.0, 21), (8, 2, 8.0, 22), (8, 2, 0.5, 23)]


class _Worlds(object):
    def __init__(self, tmp_factory):
        self._tmp = tmp_factory
        self._single = {}
        self._done = {}

    def single(self, case):
        if case not in self._single:
            self._single[case] = C.run('jax', case, 'single')
        return self._single[case]

    def world(self, n):
        if n not in self._done:
            work = str(self._tmp.mktemp('moe%d' % n))
            for case, _ in MOE_JOBS:
                with open(os.path.join(work, 'init_%s.pkl' % case),
                          'wb') as fh:
                    pickle.dump(self.single(case)['init'], fh)
            jobs = [('job_moe_case', c, m) for c, m in MOE_JOBS] + \
                [('job_moe_apply',) + a for a in APPLY]
            ranks = C.spawn_ranks(work, n, jobs, timeout=120)
            refs = {(c, m): C.run('jax', c, m, n=n) for c, m in MOE_JOBS}
            self._done[n] = (ranks, refs)
        return self._done[n]


@pytest.fixture(scope='module')
def worlds(tmp_path_factory):
    return _Worlds(tmp_path_factory)


def _ok(ranks, job):
    for res in ranks:
        assert res[job][0] == 'ok', res[job][1]
    return [res[job][1] for res in ranks]


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * float(np.max(np.abs(want))),
                               err_msg=what)


@pytest.mark.parametrize('world', [2, 4])
@pytest.mark.parametrize('case,mode', MOE_JOBS)
def test_moe_training_matches_the_jax_mesh(worlds, world, case, mode):
    ranks, refs = worlds.world(world)
    got = _ok(ranks, ('job_moe_case', case, mode))
    ref = refs[(case, mode)]
    n_exp = {'moe_e4': 4, 'moe_e8': 8, 'moe_e3': 3, 'moe_drop': 4}[case]
    mesh_path = n_exp % world == 0
    # the rule took the mesh path (one call a step) or the dense one
    assert got[0]['mesh_calls'] == (len(ref['fetches']) if mesh_path
                                    else 0)
    for step, (g, w) in enumerate(zip(got[0]['fetches'], ref['fetches'])):
        for i, (a, b) in enumerate(zip(g, w)):
            _close(a, b, '%s step %d fetch %d' % (case, step, i))
    for k, b in ref['params'].items():
        _close(got[0]['params'][k], b, '%s %s' % (case, k))
    for other in got[1:]:
        for g, o in zip(got[0]['fetches'], other['fetches']):
            for a, b in zip(g, o):
                np.testing.assert_array_equal(a, b)
    # the auxiliary loss is the global batch's: step 1's equals the
    # single-device step's (the same weights and tokens)
    single = worlds.single(case)
    _close(got[0]['fetches'][0][1], single['fetches'][0][1], 'aux')
    if case == 'moe_drop':
        # the per-rank drops move the output off the single device's
        assert not np.allclose(got[0]['fetches'][0][2],
                               single['fetches'][0][2], rtol=1e-4)


@pytest.mark.parametrize('world', [2, 4])
@pytest.mark.parametrize('n_exp,top_k,cf,seed', APPLY)
def test_moe_apply_matches_the_jax_ep_mesh(worlds, world, n_exp, top_k, cf,
                                           seed):
    ranks, _ = worlds.world(world)
    got = np.concatenate(_ok(ranks, ('job_moe_apply', n_exp, top_k, cf,
                                     seed)))
    w, x, logits = C.moe_apply_inputs(n_exp, top_k, cf, seed)
    mesh = jparallel.make_mesh({'ep': world},
                               devices=jax.devices()[:world])
    want = np.asarray(jmoe.moe_apply(
        lambda p, t: t @ p['w'], {'w': jnp.asarray(w)}, jnp.asarray(x),
        jnp.asarray(logits), mesh, axis='ep', capacity_factor=cf,
        top_k=top_k))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_stack_expert_params_like_jax():
    rng = np.random.RandomState(17)
    experts = [{'w': rng.randn(3, 4).astype('float32'),
                'b': [rng.randn(4).astype('float32')]} for _ in range(5)]
    j = jmoe.stack_expert_params([
        {'w': jnp.asarray(e['w']), 'b': [jnp.asarray(e['b'][0])]}
        for e in experts])
    t = tmoe.stack_expert_params([
        {'w': torch.from_numpy(e['w']), 'b': [torch.from_numpy(e['b'][0])]}
        for e in experts])
    np.testing.assert_array_equal(t['w'].numpy(), np.asarray(j['w']))
    np.testing.assert_array_equal(t['b'][0].numpy(), np.asarray(j['b'][0]))


def _op_list(program):
    return [(op.type,
             {k: [v.name for v in vs] for k, vs in sorted(op.inputs.items())},
             {k: [v.name for v in vs] for k, vs in sorted(op.outputs.items())})
            for op in program.global_block().ops]


def test_amp_pass_casts_the_whole_moe_bundle_like_jax():
    """The AMP pass's moe_mlp entry (every input slot: x, the gate and the
    four expert parameters go to bf16): the port's rewrite is the JAX
    rewrite op for op, with the same report and var dtypes; the rewritten
    program runs."""
    from paddle_tpu.fluid import passes as jpasses
    from paddle_tpu_torch.fluid import passes as tpasses
    progs = {}
    for fluid, framework, pkg in ((jfluid, jframework, 'jax'),
                                  (tfluid, tframework, 'port')):
        main, startup = framework.Program(), framework.Program()
        with fluid.unique_name.guard(), \
                framework.program_guard(main, startup):
            x = fluid.layers.data(name='x', shape=[8], dtype='float32')
            out = fluid.layers.moe_mlp(x, num_experts=4, hidden_size=8,
                                       top_k=2)
        fluid.amp.decorate_program(main)
        opt, rep = (jpasses if pkg == 'jax' else tpasses).optimize(
            main, fetches=[out.name])
        progs[pkg] = (opt, rep, startup, out.name)
    (jopt, jrep, _, _), (topt, trep, tstart, tout) = \
        progs['jax'], progs['port']
    assert _op_list(topt) == _op_list(jopt)
    assert trep.to_dict() == jrep.to_dict()
    assert trep.passes['amp']['ops_rewritten'] == 1
    assert [op.type for op in topt.global_block().ops].count('cast') >= 6
    jv = {v.name: (v.dtype, v.shape) for v in jopt.list_vars()}
    tv = {v.name: (v.dtype, v.shape) for v in topt.list_vars()}
    assert tv == jv
    sc = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(tstart, scope=sc)
    got, = exe.run(topt, feed={'x': np.random.RandomState(0).randn(
        12, 8).astype('float32')}, fetch_list=[tout], scope=sc)
    assert got.shape == (12, 8) and np.isfinite(got).all()
