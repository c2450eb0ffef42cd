"""The port's data parallelism against the JAX package's dp mesh, on the CPU.

The JAX package runs each case on its virtual CPU mesh (dp 2 and 4 of the 8
devices the conftest makes) and on one device, in this process. The port
runs the same program from the JAX startup's weights on 2 and 4 gloo ranks
spawned by tests/torch_mesh_cases.py (a FileStore under tmp_path, no
ports), one spawn per world size for every case of this file; every spawn
joins within its 120 s timeout or its ranks are killed and the test fails.
Each rank returns the global fetches, and the parameters after the last
step are gathered from the ranks' ZeRO blocks (parallel.full_state).

Held within rtol 2e-5 (the JAX tests' bound, test_parallel.py:354-372) of
both the JAX dp run and the JAX single-device run: the loss of every step,
and every persistable after the last, each tensor with an absolute floor of
2e-5 of its largest magnitude (a parameter element near zero carries the
float-sum noise of its whole tensor). The cases:

  * the JAX tests' nets (test_parallel.py:17-50, 306-350) through
    ParallelExecutor, set_mesh, run_bundle and DistributeTranspiler;
  * conv + batch_norm (the global batch's statistics);
  * a 2-layer, d 32 Transformer whose padding sits unevenly on the shards
    (the token-weighted loss);
  * a sequence_conv_pool net fed a LoDTensor;
  * a DeepFM with is_sparse tables (their dense, averaged gradient);
  * a loss of whole-tensor norms of a batch activation (squared_l2_norm,
    clip_by_norm, dice_loss), which must see the global batch;
  * ZeRO: BuildStrategy.Reduce, the transpiler's ZeRO accumulators and
    shard_parameters, each equal to the unsharded run.

Also: a batch the data axis does not divide raises "not divisible",
LocalSGD against a numpy simulation, Trainer(parallel=True) against the
single-device Trainer, and, in one process, set_mesh's validation and
round trips, the sync_mode=False warning and the pserver shims.
"""
import os
import pickle
import warnings

import numpy as np
import pytest

import jax  # noqa: F401  (the conftest pins it to 8 CPU devices)

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import framework as jframework

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import framework as tframework

import torch_mesh_cases as C

# (case, mode) pairs each world runs
JOBS = [
    ('fc', 'pe'), ('fc', 'mesh'),
    ('annotated', 'mesh'), ('annotated', 'bundle'), ('annotated', 'dist'),
    ('zero', 'mesh'), ('zero', 'reduce'), ('zero', 'dist'), ('zero', 'fsdp'),
    ('bn', 'mesh'), ('bn', 'pe'),
    ('transformer', 'mesh'),
    ('seq', 'mesh'),
    ('deepfm', 'pe'),
    ('norms', 'mesh'),
]
WORLDS = (2, 4)
RTOL = 2e-5


class _Worlds(object):
    """The JAX references and the port's ranks, one spawn per world."""

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
            work = str(self._tmp.mktemp('mesh%d' % n))
            for case in sorted({c for c, _ in JOBS}):
                with open(os.path.join(work, 'init_%s.pkl' % case),
                          'wb') as fh:
                    pickle.dump(self.single(case)['init'], fh)
            jobs = [('job_case', c, m) for c, m in JOBS] + [
                ('job_not_divisible',), ('job_local_sgd',), ('job_trainer',),
                ('job_helpers',), ('job_bn_test_clone',)]
            ranks = C.spawn_ranks(work, n, jobs, timeout=120)
            refs = {(c, m): C.run('jax', c, m, n=n) for c, m in JOBS}
            self._done[n] = (ranks, refs)
        return self._done[n]


@pytest.fixture(scope='module')
def worlds(tmp_path_factory):
    return _Worlds(tmp_path_factory)


def _result(ranks, job):
    status, val = ranks[0][job]
    assert status == 'ok', val
    for r, res in enumerate(ranks[1:], 1):
        assert res[job][0] == 'ok', res[job][1]
    return val


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    floor = RTOL * float(np.max(np.abs(want))) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=floor,
                               err_msg=what)


@pytest.mark.parametrize('world', WORLDS)
@pytest.mark.parametrize('case,mode', JOBS)
def test_ranks_match_the_jax_mesh_and_one_device(worlds, world, case, mode):
    ranks, refs = worlds.world(world)
    got = _result(ranks, ('job_case', case, mode))
    for ref, name in ((refs[(case, mode)], 'jax dp%d' % world),
                      (worlds.single(case), 'jax single')):
        assert len(got['fetches']) == len(ref['fetches'])
        for step, (g, w) in enumerate(zip(got['fetches'], ref['fetches'])):
            for i, (a, b) in enumerate(zip(g, w)):
                _close(a, b, '%s %s step %d fetch %d vs %s'
                       % (case, mode, step, i, name))
        missing = set(ref['params']) - set(got['params'])
        assert not missing, missing
        for k, b in ref['params'].items():
            _close(got['params'][k], b, '%s %s %s vs %s'
                   % (case, mode, k, name))
    # every rank returns the same (global) fetches
    for res in ranks[1:]:
        other = res[('job_case', case, mode)][1]
        for g, o in zip(got['fetches'], other['fetches']):
            for a, b in zip(g, o):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('world', WORLDS)
def test_non_divisible_batch_raises(worlds, world):
    ranks, _ = worlds.world(world)
    msg = _result(ranks, ('job_not_divisible',))
    assert msg is not None and 'not divisible' in msg, msg


@pytest.mark.parametrize('world', WORLDS)
def test_local_sgd_matches_numpy_simulation(worlds, world):
    """test_distribute.py:249-330: replicas diverge over 3 local steps and
    one average mixes them; sync_steps=1 is full-batch SGD."""
    ranks, _ = worlds.world(world)
    n, bl, d, lr = world, 4, 6, 0.1
    rng = np.random.RandomState(0)
    w0 = rng.rand(d).astype('float32')
    xs = rng.rand(3, n * bl, d).astype('float32')
    ys = rng.rand(3, n * bl).astype('float32')
    sim = np.tile(w0, (n, 1)).astype(np.float64)
    for i in range(3):
        for r in range(n):
            x = xs[i, r * bl:(r + 1) * bl]
            y = ys[i, r * bl:(r + 1) * bl]
            sim[r] = sim[r] - lr * 2.0 / bl * x.T @ (x @ sim[r] - y)
    ref = w0.astype(np.float64)
    for i in range(3):
        per = [2.0 / bl * xs[i, r * bl:(r + 1) * bl].T @ (
            xs[i, r * bl:(r + 1) * bl] @ ref - ys[i, r * bl:(r + 1) * bl])
            for r in range(n)]
        ref = ref - lr * np.mean(per, axis=0)
    for r, res in enumerate(ranks):
        status, got = res[('job_local_sgd',)]
        assert status == 'ok', got
        # each rank stepped its own copy on its own rows
        np.testing.assert_allclose(got['pre'], sim[r], rtol=2e-5)
        np.testing.assert_allclose(got['synced'], sim.mean(axis=0),
                                   rtol=2e-5)
        np.testing.assert_allclose(got['sync1'], ref, rtol=2e-5)
        assert got['aux_shape'] == ()
    pres = [res[('job_local_sgd',)][1]['pre'] for res in ranks]
    assert np.abs(pres[0] - pres[1]).max() > 1e-6


@pytest.mark.parametrize('world', WORLDS)
def test_trainer_parallel_matches_one_device(worlds, world):
    ranks, _ = worlds.world(world)
    got = _result(ranks, ('job_trainer',))
    want = C.trainer_run(jfluid, parallel=False)
    assert len(got) == len(want) == 4
    np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize('world', WORLDS)
def test_collectives_and_sharding_helpers(worlds, world):
    """psum, all_gather (tiled and stacked), reduce_scatter and ppermute
    against numpy, their gradients under a rank-dependent cotangent too
    (the transposes: psum, reduce_scatter, all_gather, the inverse
    permutation); shard_batch, replicate, shard_optimizer_states,
    fsdp_shard_params and shard_params_by_rules give each rank its block,
    tagged with the JAX spec."""
    ranks, _ = worlds.world(world)
    n = world
    xs = [(np.arange(8, dtype=np.float32) + 10 * r).reshape(4, 2)
          for r in range(n)]
    w = np.arange(8 * 2048, dtype=np.float32).reshape(8, 2048)
    b = np.arange(6, dtype=np.float32)

    def cot(shape, r):
        return np.arange(int(np.prod(shape)), dtype=np.float32).reshape(
            shape) * (r + 1)

    for r, res in enumerate(ranks):
        status, got = res[('job_helpers',)]
        assert status == 'ok', got
        y, g = got['psum']
        np.testing.assert_array_equal(y, sum(xs))
        np.testing.assert_array_equal(g, sum(cot((4, 2), q)
                                             for q in range(n)))
        y, g = got['all_gather']
        np.testing.assert_array_equal(y, np.concatenate(xs))
        np.testing.assert_array_equal(g, sum(
            cot((4 * n, 2), q) for q in range(n))[4 * r:4 * r + 4])
        y, _ = got['all_gather_stacked']
        np.testing.assert_array_equal(y, np.stack(xs, axis=1))
        y, g = got['reduce_scatter']
        full = sum(np.tile(x, (n, 1)) for x in xs)
        np.testing.assert_array_equal(y, full[4 * r:4 * r + 4])
        # the all_gather of the cotangents, its n blocks summed by the
        # repeat's backward
        np.testing.assert_array_equal(g, sum(cot((4, 2), q)
                                             for q in range(n)))
        y, g = got['ppermute']
        np.testing.assert_array_equal(y, xs[(r - 1) % n])
        np.testing.assert_array_equal(g, cot((4, 2), (r + 1) % n))
        rows = 8 // n
        np.testing.assert_array_equal(got['shard_batch'],
                                      w[r * rows:(r + 1) * rows])
        np.testing.assert_array_equal(got['replicate'], b)
        blk, spec = got['zero_w']
        np.testing.assert_array_equal(blk, w[r * rows:(r + 1) * rows])
        assert spec == ('dp', None)
        assert got['zero_b'][1] == (('dp',) if 6 % n == 0 else ())
        blk, spec = got['fsdp_w']          # [2048, 8]: dim 0 divides
        np.testing.assert_array_equal(blk, w.T[r * (2048 // n):
                                               (r + 1) * (2048 // n)])
        assert spec == ('dp',)
        assert got['fsdp_b'][1] == ()       # under 1024 elements
        blk, spec = got['rules_fc.w']
        np.testing.assert_array_equal(blk, w[:, r * (2048 // n):
                                             (r + 1) * (2048 // n)])
        assert spec == (None, 'dp')
        np.testing.assert_array_equal(got['rules_fc.b'][0], b)
        assert got['global_batch'] is True


@pytest.mark.parametrize('world', WORLDS)
def test_for_test_clone_runs_on_the_mesh(worlds, world):
    """After 3 mesh steps of the batch-norm net, its for_test clone on the
    mesh (batch norm from the running statistics, which stay replicated)
    gives the JAX single-device probabilities."""
    ranks, _ = worlds.world(world)
    got = _result(ranks, ('job_bn_test_clone',))
    want, _ = C.bn_test_clone('jax')
    _close(got[0], want, 'bn test clone')
    for res in ranks[1:]:
        np.testing.assert_array_equal(res[('job_bn_test_clone',)][1][0],
                                      got[0])


# -- in one process -----------------------------------------------------------

def test_set_mesh_validation_like_jax():
    """test_parallel.py:448-475, in both packages: the same errors."""
    for framework in (jframework, tframework):
        p = framework.Program()
        with pytest.raises(ValueError, match='duplicate mesh axis'):
            p.set_mesh([('dp', 4), ('dp', 2)])
        with pytest.raises(ValueError, match='has size'):
            p.set_mesh({'dp': 0})
        with pytest.raises(ValueError, match='not a mesh axis'):
            p.set_mesh({'dp': 8}, data_axis='model')
        with pytest.raises(ValueError, match='at least one'):
            p.set_mesh([])
        p.set_mesh({'dp': 8})
        assert p.mesh_axes == {'dp': 8} and p._mesh_data_axis == 'dp'
        p.set_mesh(None)
        assert p.mesh_axes is None


@pytest.mark.parametrize('data_axis', [None, False])
def test_mesh_survives_clone_and_serialization(data_axis):
    """The mesh and the per-var specs ride clone() and _to_dict/_from_dict
    as in the JAX package (a program saved by either loads in the other);
    an unannotated program serializes without them."""
    dicts = []
    for fluid, framework in ((jfluid, jframework), (tfluid, tframework)):
        main, startup = framework.Program(), framework.Program()
        with fluid.unique_name.guard(), \
                framework.program_guard(main, startup):
            x = fluid.layers.data(name='x', shape=[16], dtype='float32')
            fluid.layers.fc(input=x, size=8, param_attr=fluid.ParamAttr(
                sharding=(None, 'dp')))
        main.set_mesh({'dp': 2, 'model': 1}, data_axis=data_axis)
        d = main._to_dict()
        want = 'dp' if data_axis is None else False
        assert d['mesh'] == {'axes': [['dp', 2], ['model', 1]],
                             'data_axis': want}
        for prog in (framework.Program._from_dict(d), main.clone()):
            assert prog._mesh_axes == (('dp', 2), ('model', 1))
            assert prog._mesh_data_axis == want
            assert prog.global_block().vars['fc_0.w_0'].sharding == \
                (None, 'dp')
        dicts.append(d)
        plain = framework.Program()
        assert 'mesh' not in plain._to_dict()
    assert dicts[0]['mesh'] == dicts[1]['mesh']
    for dj, dt in zip(dicts[0]['blocks'][0]['vars'],
                      dicts[1]['blocks'][0]['vars']):
        assert dj['name'] == dt['name']
        assert dj.get('sharding') == dt.get('sharding')
    # the JAX program's desc loads in the port
    p = tframework.Program._from_dict(dicts[0])
    assert p.mesh_axes == {'dp': 2, 'model': 1}
    assert p.global_block().vars['fc_0.w_0'].sharding == (None, 'dp')


def test_tensor_parallel_axis_raises_at_run_time():
    """A non-data axis of size > 1 is accepted at build and refused when the
    program runs, naming the queue item."""
    main, startup, loss, _ = C.build('port', 'annotated')
    main.set_mesh({'dp': 1, 'model': 2})
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    f = C.feeds('port', 'annotated')[0]
    with pytest.raises(NotImplementedError, match='Parallel'):
        exe.run(main, feed=f, fetch_list=[loss], scope=scope)


@pytest.mark.parametrize('op_type,attrs,want', [
    ('squared_l2_norm', {}, 'gather'),
    ('l1_norm', {}, 'gather'),
    ('clip_by_norm', {'max_norm': 1.0}, 'gather'),
    ('isfinite', {}, 'gather'),
    ('fake_quantize', {}, 'gather'),
    ('softmax', {}, 'local'),
    ('layer_norm', {'begin_norm_axis': 1}, 'local'),
    ('layer_norm', {'begin_norm_axis': 0}, 'gather'),
    ('concat', {'axis': 1}, 'local'),
    ('concat', {}, 'gather'),
    ('arg_max', {}, 'gather'),
    ('arg_max', {'axis': 1}, 'local'),
])
def test_ops_not_known_row_wise_see_the_global_batch(op_type, attrs, want):
    """On a dp mesh only an op known to be row-wise (away from the batch
    axis) runs on a rank's rows; any other op on a batch-sharded input,
    whole-tensor norms included, runs on the gathered global rows."""
    from paddle_tpu_torch.fluid import mesh_step
    from paddle_tpu_torch.fluid.layer_helper import LayerHelper
    main, startup = tframework.Program(), tframework.Program()
    with tframework.program_guard(main, startup):
        x = tfluid.layers.data(name='x', shape=[8], dtype='float32')
        helper = LayerHelper(op_type)
        out = helper.create_variable_for_type_inference(dtype='float32')
        helper.append_op(type=op_type, inputs={'X': [x]},
                         outputs={'Out': [out]}, attrs=attrs)
    op = main.global_block().ops[-1]
    assert mesh_step._classify(op, {x.name}) == want


def test_one_rank_mesh_without_a_group_is_the_plain_step():
    """set_mesh({'dp': 1}) with no process group runs the single-device
    step, bitwise."""
    out = []
    for mesh in (None, {'dp': 1}):
        main, startup, loss, _ = C.build('port', 'annotated')
        if mesh:
            main.set_mesh(mesh)
        scope = tfluid.Scope()
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup, scope=scope)
        out.append([exe.run(main, feed=f, fetch_list=[loss], scope=scope)[0]
                    for f in C.feeds('port', 'annotated')])
    np.testing.assert_array_equal(out[0], out[1])


def test_sync_mode_false_warns_once_like_jax():
    for fluid, pkg in ((jfluid, 'jax'), (tfluid, 'port')):
        main, startup, loss, _ = C.build(pkg, 'annotated')
        fluid.DistributeTranspiler().transpile(
            trainer_id=0, trainers=1, program=main, sync_mode=False)
        exe = fluid.Executor(fluid.CPUPlace())
        scope = fluid.Scope() if pkg == 'port' else \
            jfluid.executor.Scope()
        f = C.feeds(pkg, 'annotated')[0]
        with fluid.scope_guard(scope):
            exe.run(startup)
            with pytest.warns(UserWarning, match='LocalSGD'):
                exe.run(main, feed=f, fetch_list=[loss])
            with warnings.catch_warnings():
                warnings.simplefilter('error')
                exe.run(main, feed=f, fetch_list=[loss])


def test_pserver_shims_like_jax():
    """test_distribute.py:123-142 in both packages, and the dispatchers."""
    for fluid, pkg in ((jfluid, 'jax'), (tfluid, 'port')):
        main, startup, _, _ = C.build(pkg, 'annotated')
        t = fluid.DistributeTranspiler()
        with pytest.warns(DeprecationWarning, match='set_mesh'):
            t.transpile(trainer_id=0, trainers=4, program=main,
                        startup_program=startup,
                        pservers='10.0.0.1:6174,10.0.0.2:6174')
        assert t.get_trainer_program() is main
        ps = t.get_pserver_program('10.0.0.2:6174')
        assert isinstance(ps, fluid.Program)
        assert len(ps.global_block().ops) == len(main.global_block().ops)
        assert ps._dist_config['shard_owner'] == 1
        assert ps._dist_config['n_shard_owners'] == 2
        assert ps._dist_config['dp_size'] == 4
        assert ps._dist_config['shard_optimizer_states'] is True
        with pytest.raises(ValueError, match='unknown pserver endpoint'):
            t.get_pserver_program('not-an-endpoint')
        prog, sp = t.get_pserver_programs('10.0.0.1:6174')
        assert sp is startup
        assert t.get_startup_program('10.0.0.2:6174') is startup
        eps = ['a:1', 'b:2', 'c:3']
        with pytest.warns(DeprecationWarning):
            rr = fluid.transpiler.RoundRobin(eps)
        vs = list(main.global_block().vars.values())[:5]
        assert rr.dispatch(vs) == ['a:1', 'b:2', 'c:3', 'a:1', 'b:2']
        with pytest.warns(DeprecationWarning):
            hn = fluid.transpiler.HashName(eps)
        assert hn.dispatch(vs) == [eps[hash(v.name) % 3] for v in vs]


def test_parallel_executor_build_strategy_and_warning_like_jax():
    for fluid in (jfluid, tfluid):
        bs = fluid.BuildStrategy()
        assert bs.reduce_strategy == \
            fluid.BuildStrategy.ReduceStrategy.AllReduce == 0
        assert fluid.BuildStrategy.ReduceStrategy.Reduce == 1
        assert bs.gradient_scale_strategy == 0
        es = fluid.ExecutionStrategy()
        assert (es.num_threads, es.use_event, es.allow_op_delay,
                es.num_iteration_per_drop_scope) == (0, True, False, 1)


def test_init_and_entry_points_default_to_the_card():
    """Without a card, init_distributed() (NCCL) and
    ParallelExecutor(use_cuda=None) raise instead of running on the CPU;
    init_multihost without a cluster environment joins nothing, as in the
    JAX package."""
    import torch
    from paddle_tpu_torch import parallel
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present: the no-card contract does not '
                    'apply')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        parallel.init_distributed()
    main, _, loss, _ = C.build('port', 'fc')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        tfluid.ParallelExecutor(loss_name=loss, main_program=main)
    import paddle_tpu.parallel as jparallel
    for k in ('PADDLE_TRAINER_ENDPOINTS', 'PADDLE_TRAINERS',
              'PADDLE_TRAINER_ID'):
        os.environ.pop(k, None)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', DeprecationWarning)
        assert parallel.init_multihost() is False
        assert jparallel.init_multihost() is False
    assert parallel.process_count() == 1 and parallel.process_index() == 0
    with pytest.raises(ValueError, match='only 1 available'):
        parallel.make_mesh({'dp': 2})
    mesh = parallel.make_mesh()
    assert dict(mesh.shape) == {'dp': 1} and mesh.coords == {'dp': 0}
