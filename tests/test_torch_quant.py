"""Int8 weight quantization in the PyTorch port (ops_impl/quant_ops.py,
passes/quant_pass.py, embedding/quant_rows.py, int8 artifacts through
save_inference_model, load_inference_model and the Predictor) against the
JAX package, on the CPU, at small sizes, with numpy inputs from a seed:

  * quantize_array bitwise (int8 and scales) over shapes, axes, an
    all-zero channel, ties at half a step and 1-D / 0-D inputs;
  * the rules quantize, dequantize and quant_lookup_table against the JAX
    rules at 1e-6, with an id past V, a negative id (wrapping, and below
    -V), padding_idx and 3-D ids;
  * mark_quant (the pipeline form, through optimize and through the
    executor) and quantize_weights (the offline form) on a small fc +
    embedding net: the same op types and names after the rewrite as JAX's,
    the same int8 and scales, outputs at 1e-6 from the JAX weights;
  * an int8 artifact: the fp32 weights gone from the block and the file,
    int8 bytes in it, served by the Predictor as run in memory; the JAX
    package's int8 artifact served by the port's Predictor at 1e-6;
  * the embedding row codec rounding through quantize_array.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu.fluid as jfluid
from paddle_tpu.embedding import quant_rows as jquant_rows
from paddle_tpu.fluid import framework as jframework
from paddle_tpu.fluid import lowering as jlowering
from paddle_tpu.fluid import passes as jpasses
from paddle_tpu.fluid import unique_name as junique
from paddle_tpu.fluid.executor import Scope as JScope
from paddle_tpu.fluid.executor import _switch_scope as j_switch_scope
from paddle_tpu.fluid.ops_impl import quant_ops as jquant
from paddle_tpu.fluid.passes import quant_pass as jquant_pass

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import inference as tinference
from paddle_tpu_torch.embedding import quant_rows as tquant_rows
from paddle_tpu_torch.fluid import framework as tframework
from paddle_tpu_torch.fluid import lowering as tlowering
from paddle_tpu_torch.fluid import passes as tpasses
from paddle_tpu_torch.fluid import unique_name as tunique
from paddle_tpu_torch.fluid.ops_impl import quant_ops as tquant
from paddle_tpu_torch.fluid.passes import quant_pass as tquant_pass

VOCAB, DIM = 11, 6
TOL = 1e-6

JAX = (jfluid, jframework, junique)
PORT = (tfluid, tframework, tunique)


def _arrays(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(7, 5).astype('float32')
    x[2] = 0.0                                  # an all-zero channel
    x[3] = np.array([31.75, -0.125, 0.375, 2.625, -5.5], 'float32')
    return {'2d': x,
            '3d': rng.randn(3, 4, 5).astype('float32') * 10,
            '1d': rng.randn(9).astype('float32'),
            '0d': np.float32(-2.5),
            'ties': (np.arange(-8, 9, dtype='float32') * 0.5)}


@pytest.mark.parametrize('name,axis', [
    ('2d', 0), ('2d', 1), ('2d', -1), ('3d', 0), ('3d', 1), ('3d', 2),
    ('1d', 0), ('0d', 0), ('ties', 0)])
def test_quantize_array_is_bitwise_jax(name, axis):
    x = _arrays()[name]
    jq, js = jquant.quantize_array(jnp.asarray(x), axis=axis)
    tq, ts = tquant.quantize_array(torch.from_numpy(np.array(x)), axis=axis)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert ts.shape == js.shape
    np.testing.assert_array_equal(ts.numpy().view(np.int32),
                                  np.asarray(js).view(np.int32))


def test_quantize_array_takes_numpy_and_keeps_the_device():
    x = _arrays()['2d']
    q, s = tquant.quantize_array(x, axis=0)
    assert q.device.type == 'cpu' and tuple(s.shape) == (7, 1)
    assert (q.numpy()[2] == 0).all()
    assert s.numpy()[2, 0] == np.float32(tquant.SCALE_FLOOR)
    # row 3's absmax 31.75 gives a scale of 0.25: the half steps tie
    assert s.numpy()[3, 0] == np.float32(0.25)
    np.testing.assert_array_equal(q.numpy()[3], [127, 0, 2, 10, -22])


def test_row_codec_rounds_through_quantize_array():
    vals = np.random.RandomState(3).randn(14, 7).astype('float32')
    vals[4] = 0.0
    q, s = tquant_rows.quantize_rows(vals)
    aq, as_ = tquant.quantize_array(vals, axis=0)
    np.testing.assert_array_equal(q, aq.numpy())
    np.testing.assert_array_equal(s, as_.numpy())
    jq, js = jquant_rows.quantize_rows(vals)
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(s, js)
    assert isinstance(q, np.ndarray) and isinstance(s, np.ndarray)


# -- the rules -------------------------------------------------------------------

def _jrule(op_type, ins, attrs):
    ctx = jlowering.Ctx(jax.random.key(0), op_index=0)
    return jlowering.get_rule(op_type)(
        {k: [jnp.asarray(v) for v in vs] for k, vs in ins.items()}, attrs,
        ctx)


def _trule(op_type, ins, attrs):
    ctx = tlowering.Ctx(torch.device('cpu'))
    return tlowering.get_rule(op_type)(
        {k: [torch.from_numpy(np.array(v)) for v in vs]
         for k, vs in ins.items()}, attrs, ctx)


@pytest.mark.parametrize('axis', [0, 1])
def test_quantize_and_dequantize_rules_are_the_jax_rules(axis):
    x = _arrays()['2d']
    j = _jrule('quantize', {'X': [x]}, {'axis': axis})
    t = _trule('quantize', {'X': [x]}, {'axis': axis})
    np.testing.assert_array_equal(t['Out'].numpy(), np.asarray(j['Out']))
    np.testing.assert_array_equal(t['Scale'].numpy(), np.asarray(j['Scale']))
    jd = _jrule('dequantize', {'X': [np.asarray(j['Out'])],
                               'Scale': [np.asarray(j['Scale'])]}, {})
    td = _trule('dequantize', {'X': [t['Out'].numpy()],
                               'Scale': [t['Scale'].numpy()]}, {})
    assert td['Out'].dtype == torch.float32
    np.testing.assert_allclose(td['Out'].numpy(), np.asarray(jd['Out']),
                               rtol=TOL, atol=TOL)
    assert np.abs(td['Out'].numpy() - x).max() <= \
        np.abs(x).max() / 254.0 + 1e-7


@pytest.mark.parametrize('padding_idx', [None, -1, 3, 0])
@pytest.mark.parametrize('ids_shape', ['flat', 'col', '3d'])
def test_quant_lookup_table_is_the_jax_rule(padding_idx, ids_shape):
    """Ids past V read NaN rows, [-V, 0) wraps, below -V reads NaN; the
    padding row zeroes through its scale; the JAX rule's values (a
    negative padding_idx means none, in both rules)."""
    rng = np.random.RandomState(9)
    w = rng.randn(VOCAB, DIM).astype('float32')
    q, s = jquant.quantize_array(jnp.asarray(w), axis=0)
    q, s = np.asarray(q), np.asarray(s)
    ids = np.array([0, 3, VOCAB, -1, -VOCAB, -VOCAB - 1, VOCAB + 5, 3, 7],
                   dtype='int64')
    ids = {'flat': ids, 'col': ids[:, None],
           '3d': np.concatenate([ids, ids[:3]]).reshape(3, 4, 1)}[ids_shape]
    attrs = {} if padding_idx is None else {'padding_idx': padding_idx}
    j = np.asarray(_jrule('quant_lookup_table',
                          {'W': [q], 'Scale': [s], 'Ids': [ids]},
                          attrs)['Out'])
    t = _trule('quant_lookup_table', {'W': [q], 'Scale': [s], 'Ids': [ids]},
               attrs)['Out']
    assert t.dtype == torch.float32 and tuple(t.shape) == j.shape
    t = t.numpy()
    np.testing.assert_array_equal(np.isnan(t), np.isnan(j))
    assert np.isnan(t).any()
    np.testing.assert_allclose(t, j, rtol=TOL, atol=TOL)
    if padding_idx is not None and padding_idx >= 0:
        rows = t.reshape(-1, DIM)[ids.reshape(-1) == padding_idx]
        assert (rows == 0).all()


# -- the passes on an fc + embedding net ----------------------------------------

def _net(fluid):
    layers = fluid.layers
    ids = layers.data(name='ids', shape=[3, 1], dtype='int64')
    emb = layers.embedding(ids, size=[VOCAB, DIM], is_sparse=False,
                           param_attr=fluid.ParamAttr(name='emb_w'))
    return layers.fc(input=emb, size=5, num_flatten_dims=2,
                     param_attr=fluid.ParamAttr(name='fc_w'))


def _programs(pkg):
    fluid, framework, unique_name = pkg
    main, startup = framework.Program(), framework.Program()
    with unique_name.guard(), framework.program_guard(main, startup):
        out = _net(fluid)
    return main, startup, out


def _feed(seed=2):
    rng = np.random.RandomState(seed)
    return {'ids': rng.randint(0, VOCAB, size=(4, 3, 1)).astype('int64')}


def _jax_state():
    """The JAX net after its startup program: (main, out, scope, {name:
    array})."""
    main, startup, out = _programs(JAX)
    scope = JScope()
    prev = j_switch_scope(scope)
    try:
        jfluid.Executor(jfluid.CPUPlace()).run(startup)
    finally:
        j_switch_scope(prev)
    state = {n: np.asarray(v) for n, v in scope.vars.items()
             if v is not None}
    return main, out, scope, state


def _jax_run(program, scope, fetch, feed):
    prev = j_switch_scope(scope)
    try:
        return np.asarray(jfluid.Executor(jfluid.CPUPlace()).run(
            program, feed=feed, fetch_list=[fetch])[0])
    finally:
        j_switch_scope(prev)


def _port_scope(state):
    sc = tfluid.Scope()
    sc.load_numpy(state, tfluid.CPUPlace())
    return sc


def _names(program):
    return [(op.type, sorted(op.input_arg_names), sorted(op.output_arg_names))
            for op in program.global_block().ops]


def test_mark_quant_rewrites_as_jax_and_matches_its_outputs():
    jmain, jout, jscope, state = _jax_state()
    tmain, _, tout = _programs(PORT)
    jquant_pass.mark_quant(jmain)
    tquant_pass.mark_quant(tmain)
    assert tquant_pass.is_quant(tmain) and tmain.clone()._quant
    jopt, jrep = jpasses.optimize(jmain, fetches=[jout.name])
    topt, trep = tpasses.optimize(tmain, fetches=[tout.name])
    assert trep.to_dict() == jrep.to_dict()
    assert trep.passes['quant'] == {'ops_rewritten': 2, 'qdq_inserted': 3}
    assert _names(topt) == _names(jopt)
    assert not tquant_pass.is_quant(topt) and topt._quant_ir
    assert {v.name: v.dtype for v in topt.list_vars()} == \
        {v.name: v.dtype for v in jopt.list_vars()}
    feed = _feed()
    want = _jax_run(jopt, jscope, jout.name, feed)
    sc = _port_scope(state)
    exe = tfluid.Executor(tfluid.CPUPlace())
    got, = exe.run(topt, feed=feed, fetch_list=[tout.name], scope=sc)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    # the executor honours the mark with PADDLE_TPU_OPT unset: the same
    # values, a cache key apart from the unmarked program's
    got2, = exe.run(tmain, feed=feed, fetch_list=[tout], scope=sc)
    np.testing.assert_array_equal(got2, got)
    tmain._quant = False
    tmain._bump_version()
    base, = exe.run(tmain, feed=feed, fetch_list=[tout], scope=sc)
    assert not np.array_equal(base, got)
    rel = np.abs(got - base).max() / np.abs(base).max()
    assert rel < 0.05
    with pytest.raises(ValueError, match='int8'):
        tquant_pass.mark_quant(tmain, weight_dtype='int4')


def test_mark_quant_restricted_to_some_op_types():
    tmain, _, tout = _programs(PORT)
    tquant_pass.mark_quant(tmain, ops=['mul'])
    opt, rep = tpasses.optimize(tmain, fetches=[tout.name])
    types = [op.type for op in opt.global_block().ops]
    assert 'quant_lookup_table' not in types and 'lookup_table' in types
    assert rep.passes['quant'] == {'ops_rewritten': 1, 'qdq_inserted': 2}


def test_quantize_weights_is_the_jax_rewrite_with_its_bits():
    jmain, jout, jscope, state = _jax_state()
    tmain, _, tout = _programs(PORT)
    feed = _feed(7)
    jinfer, tinfer = jmain.clone(for_test=True), tmain.clone(for_test=True)
    assert jquant_pass.quantize_weights(jinfer, jscope) == 2
    sc = _port_scope(state)
    assert tquant_pass.quantize_weights(tinfer, sc) == 2
    assert _names(tinfer) == _names(jinfer)
    blk = tinfer.global_block()
    assert 'emb_w' not in blk.vars and 'fc_w' not in blk.vars
    assert blk.vars['emb_w@quant.int8'].persistable
    assert blk.vars['emb_w@quant.int8'].dtype == 'int8'
    assert tinfer._quant_ir
    for n in ('emb_w@quant.int8', 'emb_w@quant.scale', 'fc_w@quant.int8',
              'fc_w@quant.scale'):
        np.testing.assert_array_equal(sc.to_numpy([n])[n],
                                      np.asarray(jscope.vars[n]), err_msg=n)
    assert tuple(sc.vars['fc_w@quant.scale'].shape) == (1, 5)
    want = _jax_run(jinfer, jscope, jout.name, feed)
    got, = tfluid.Executor(tfluid.CPUPlace()).run(
        tinfer, feed=feed, fetch_list=[tout.name], scope=sc)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    # the rows within half a step of the fp32 table, per row
    deq = sc.to_numpy(['emb_w@quant.int8'])['emb_w@quant.int8'].astype(
        np.float32) * sc.to_numpy(['emb_w@quant.scale'])['emb_w@quant.scale']
    w = state['emb_w']
    assert (np.abs(deq - w) <=
            np.abs(w).max(axis=1, keepdims=True) / 254.0 + 1e-7).all()


def _save_int8(tmp, pkg_state=None):
    """The port's net saved fp32 and int8 from one scope: (fp32 dir,
    int8 dir, in-memory int8 output, feed)."""
    tmain, tstartup, tout = _programs(PORT)
    exe = tfluid.Executor(tfluid.CPUPlace())
    sc = tfluid.Scope()
    exe.run(tstartup, scope=sc)
    f32_dir, i8_dir = os.path.join(tmp, 'fp32'), os.path.join(tmp, 'int8')
    tfluid.io.save_inference_model(f32_dir, ['ids'], [tout], exe,
                                   main_program=tmain, scope=sc)
    infer = tmain.clone(for_test=True)
    tquant_pass.quantize_weights(infer, sc)
    tfluid.io.save_inference_model(i8_dir, ['ids'],
                                   [infer.global_block().var(tout.name)],
                                   exe, main_program=infer, scope=sc)
    feed = _feed(5)
    want, = exe.run(infer, feed=feed, fetch_list=[tout.name], scope=sc)
    return f32_dir, i8_dir, want, feed


def test_an_int8_artifact_ships_int8_and_serves_as_run_in_memory(tmp_path):
    f32_dir, i8_dir, want, feed = _save_int8(str(tmp_path))
    with np.load(os.path.join(i8_dir, '__params__.npz')) as z:
        arrays = dict(z)
    assert 'emb_w' not in arrays and 'fc_w' not in arrays
    assert arrays['emb_w@quant.int8'].dtype == np.int8
    assert arrays['fc_w@quant.int8'].dtype == np.int8
    with np.load(os.path.join(f32_dir, '__params__.npz')) as z:
        f32_bytes = sum(a.nbytes for a in z.values())
    i8_bytes = sum(a.nbytes for a in arrays.values())
    assert i8_bytes < 0.5 * f32_bytes
    pred = tinference.Predictor(i8_dir, place=tfluid.CPUPlace())
    assert 'emb_w' not in pred._scope.vars
    assert pred._scope.vars['emb_w@quant.int8'].dtype == torch.int8
    got = pred.run(feed)[0]
    np.testing.assert_array_equal(got, want)
    base = tinference.Predictor(f32_dir, place=tfluid.CPUPlace()).run(feed)[0]
    assert np.abs(got - base).max() / np.abs(base).max() < 0.05


def test_the_jax_int8_artifact_serves_in_the_port(tmp_path):
    jmain, jout, jscope, _ = _jax_state()
    jinfer = jmain.clone(for_test=True)
    jquant_pass.quantize_weights(jinfer, jscope)
    d = str(tmp_path / 'jax_int8')
    prev = j_switch_scope(jscope)
    try:
        exe = jfluid.Executor(jfluid.CPUPlace())
        jfluid.io.save_inference_model(
            d, ['ids'], [jinfer.global_block().var(jout.name)], exe,
            main_program=jinfer, export_for_deployment=False)
    finally:
        j_switch_scope(prev)
    feed = _feed(11)
    want = _jax_run(jinfer, jscope, jout.name, feed)
    got = tinference.Predictor(d, place=tfluid.CPUPlace()).run(feed)[0]
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
