"""The port's DeepFM (models/deepfm.py) against the JAX package's, on the
CPU:

  * get_model emits the JAX program op for op, startup program too, and
    so does training_program, the sparse program's builder;
  * synthetic_ctr_reader yields the JAX reader's rows;
  * a small deepfm(is_sparse=True) (vocab 64, 6 fields, embed_dim 4,
    hidden [16]) with auc, from the JAX package's startup scope carried
    into the port, gives the JAX run's losses, AUCs, FM tables and their
    moments over 3 Adam and over 3 Adagrad steps, at 1e-5 (fp32 sums in
    other orders: the merge's index_add_ against XLA's segment_sum, the
    products of two libraries). Both FM tables take the sparse path in
    both packages; the JAX auc histograms are int32 (x64 off) and become
    the port's int64 on the way in.
"""
import numpy as np
import pytest

import jax  # noqa: F401  (conftest pins it to the CPU)

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import framework as jframework
from paddle_tpu.fluid import unique_name as junique
from paddle_tpu.fluid.executor import Scope as JScope
from paddle_tpu.models import deepfm as jdeepfm

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import framework as tframework
from paddle_tpu_torch.fluid import unique_name as tunique
from paddle_tpu_torch.models import deepfm as tdeepfm

from test_torch_training import _assert_same_program

JAX = (jfluid, jframework, junique, jdeepfm)
PORT = (tfluid, tframework, tunique, tdeepfm)
SMALL = dict(num_fields=6, vocab_size=64, embed_dim=4, hidden=[16])
TOL = 1e-5


def _get_model(pkg):
    fluid, framework, unique_name, deepfm = pkg
    main, startup = framework.Program(), framework.Program()
    with unique_name.guard(), framework.program_guard(main, startup):
        deepfm.get_model()
    return main, startup


@pytest.mark.parametrize('which', ['main', 'startup'])
def test_get_model_emits_the_jax_program(which):
    i = 0 if which == 'main' else 1
    j, t = _get_model(JAX)[i], _get_model(PORT)[i]
    _assert_same_program(j, t)
    types = [op.type for op in t.global_block().ops]
    if which == 'main':
        for op_type in ('lookup_table', 'square', 'concat', 'auc', 'mean',
                        'sigmoid', 'sigmoid_cross_entropy_with_logits',
                        'autodiff', 'adam'):
            assert op_type in types, op_type
        assert types.count('lookup_table') == 2


def test_reader_is_the_jax_reader():
    for n, tag in ((300, 'train'), (40, 'test')):
        got = list(tdeepfm.synthetic_ctr_reader(n, tag=tag)())
        want = list(jdeepfm.synthetic_ctr_reader(n, tag=tag)())
        assert len(got) == len(want) == n
        for (gi, gl), (wi, wl) in zip(got, want):
            np.testing.assert_array_equal(gi, wi)
            assert gl == wl


def _build_small(pkg, opt):
    fluid, framework, unique_name, deepfm = pkg
    main, startup = framework.Program(), framework.Program()
    with unique_name.guard(), framework.program_guard(main, startup):
        feat = fluid.layers.data(name='feat_ids', shape=[6], dtype='int64')
        label = fluid.layers.data(name='label', shape=[1], dtype='int64')
        cost, prob, _ = deepfm.deepfm(feat, label, is_sparse=True, **SMALL)
        auc = fluid.layers.auc(fluid.layers.concat(
            [fluid.layers.scale(prob, -1.0, 1.0), prob], axis=1), label)
        if opt == 'adam':
            fluid.optimizer.Adam(learning_rate=1e-2).minimize(cost)
        else:
            fluid.optimizer.Adagrad(learning_rate=0.05).minimize(cost)
    return main, startup, cost.name, auc.name


@pytest.mark.parametrize('opt', ['adam', 'adagrad'])
def test_training_program_is_the_sparse_program(opt):
    """deepfm.training_program (the port's one builder of the sparse CTR
    program) emits what the JAX package's model and layers give."""
    main, startup = tframework.Program(), tframework.Program()
    with tunique.guard(), tframework.program_guard(main, startup):
        avg_cost, auc, _, feeds = tdeepfm.training_program(
            optimizer=opt, learning_rate=1e-2 if opt == 'adam' else 0.05,
            **SMALL)
    jmain, jstart, jcost, jauc = _build_small(JAX, opt)
    _assert_same_program(jmain, main)
    _assert_same_program(jstart, startup)
    assert (avg_cost.name, auc.name) == (jcost, jauc)
    assert feeds == ['feat_ids', 'label']


def _feeds(n_steps, batch=16):
    rows = list(tdeepfm.synthetic_ctr_reader(n_steps * batch, num_fields=6,
                                             vocab=64)())
    return [{'feat_ids': np.stack([r[0] for r in rows[s:s + batch]]),
             'label': np.array([[r[1]] for r in rows[s:s + batch]],
                               'int64')}
            for s in range(0, n_steps * batch, batch)]


@pytest.mark.parametrize('opt', ['adam', 'adagrad'])
def test_small_sparse_deepfm_matches_the_jax_package(opt):
    feeds = _feeds(3)
    jmain, jstart, jcost, jauc = _build_small(JAX, opt)
    _assert_same_program(jmain, _build_small(PORT, opt)[0])
    jscope = JScope()
    with jfluid.scope_guard(jscope):
        jexe = jfluid.Executor(jfluid.CPUPlace())
        jexe.run(jstart)
        init = {n: np.array(v, copy=True) for n, v in jscope.vars.items()}
        jout = [jexe.run(jmain, feed=f, fetch_list=[jcost, jauc])
                for f in feeds]
        want = {n: np.array(v) for n, v in jscope.vars.items()}
    assert any(p for p in (c.sparse_plan for c in jexe._cache.values()))

    tmain, _, tcost, tauc = _build_small(PORT, opt)
    # the JAX auc histograms are int32 (x64 off); the port's are int64
    carried = {n: a.astype('int64') if a.dtype == np.int32 else a
               for n, a in init.items()}
    tscope = tfluid.Scope()
    tscope.load_numpy(carried, tfluid.CPUPlace())
    texe = tfluid.Executor(tfluid.CPUPlace())
    tout = [texe.run(tmain, feed=f, fetch_list=[tcost, tauc], scope=tscope)
            for f in feeds]
    plan = [p.sparse_plan for p in texe._cache.values() if p.sparse_plan]
    assert plan and sorted(plan[0]) == ['fm_embed', 'fm_first_w']

    for (jl, ja), (tl, ta) in zip(jout, tout):
        np.testing.assert_allclose(tl, np.asarray(jl), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(ta, np.asarray(ja), rtol=TOL, atol=TOL)
    assert abs(float(tout[-1][0][0]) - float(tout[0][0][0])) > 1e-3
    got = tscope.to_numpy(sorted(want))
    # the FM tables and their moments, among every persistable
    assert len([n for n in want if 'fm_' in n]) == \
        (6 if opt == 'adam' else 4)
    for n in want:
        if n.startswith('auc'):
            np.testing.assert_array_equal(got[n], want[n].astype('int64'))
        else:
            np.testing.assert_allclose(got[n], want[n], rtol=TOL, atol=TOL,
                                       err_msg=n)
