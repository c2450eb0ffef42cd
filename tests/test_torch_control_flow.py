"""The port's structured control flow (fluid/layers/control_flow.py,
fluid/ops_impl/block_ops.py, control_ops.py) against the JAX package's,
on the CPU.

Each of the JAX tests/test_control_flow.py programs is built through both
packages' public API on the same numpy inputs: the port emits the JAX
program op for op (every block), and the fetches agree (floats within
TOL = 1e-6 of max(1, |x|), ints and LoD exactly); where parameters are
random, the port starts from the JAX startup scope. The book-decoder
program also crosses between the packages through the JSON desc.

Then what is the port's own: a while that outlives its bound raises
RuntimeError naming the op and the bound (it never returns a truncated
result); Print returns its input; isfinite; is_empty on a dense value;
dropout masks differ from one loop iteration to the next (the bits differ
from JAX's: the port's generator advances, JAX folds the iteration into
its key).
"""
import contextlib

import numpy as np
import pytest

import jax  # noqa: F401  (conftest pins it to the CPU)

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import framework as jframework
from paddle_tpu.fluid import unique_name as junique
from paddle_tpu.fluid.executor import Scope as JScope
from paddle_tpu.fluid.executor import scope_guard as jscope_guard

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import framework as tframework
from paddle_tpu_torch.fluid import unique_name as tunique
from paddle_tpu_torch.fluid.executor import scope_guard as tscope_guard

from test_torch_training import _assert_same_program

JAX = (jfluid, jframework, junique, JScope, jscope_guard)
PORT = (tfluid, tframework, tunique, tfluid.Scope, tscope_guard)
TOL = 1e-6


def _run(pkg, build, steps=1, state=None, return_numpy=True):
    """Build with build(fluid) -> (fetch list, feed) under fresh programs,
    a fresh scope and name generator; run the startup program, load
    `state` ({name: ndarray}) over it, then run the main program `steps`
    times. Returns (main, [fetches of each step], the startup scope as
    numpy)."""
    fluid, framework, unique_name, Scope, scope_guard = pkg
    main, startup = framework.Program(), framework.Program()
    scope = Scope()
    with scope_guard(scope), unique_name.guard(), \
            framework.program_guard(main, startup):
        fetch, feed = build(fluid)
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        init = {n: np.asarray(_scope_numpy(scope, n))
                for n in _persistables(main) if _has(scope, n)}
        if state:
            _load(pkg, scope, state)
        outs = [exe.run(main, feed=feed, fetch_list=fetch,
                        return_numpy=return_numpy) for _ in range(steps)]
    return main, outs, init


def _persistables(program):
    return sorted(v.name for v in program.list_vars() if v.persistable)


def _has(scope, name):
    return scope.find_var(name) is not None


def _scope_numpy(scope, name):
    return np.asarray(scope.find_var(name).get_tensor())


def _load(pkg, scope, state):
    if pkg is PORT:
        scope.load_numpy(state, tfluid.CPUPlace())
    else:
        for n, a in state.items():
            scope.find_var(n).get_tensor().set(a, jfluid.CPUPlace())


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if want.dtype.kind in 'fc':
        scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale)
    else:
        np.testing.assert_array_equal(got.astype(np.int64),
                                      want.astype(np.int64))


def _both(build, steps=1, carry_state=False, same_program=True):
    """The program built and run in both packages; asserts the programs
    equal and returns (JAX fetches, port fetches) of the last step."""
    jmain, jout, jinit = _run(JAX, build, steps)
    tmain, tout, _ = _run(PORT, build, steps,
                          state=jinit if carry_state else None)
    if same_program:
        _assert_same_program(jmain, tmain)
    for js, ts in zip(jout, tout):
        assert len(js) == len(ts)
        for j, t in zip(js, ts):
            _close(t, j)
    return jout[-1], tout[-1]


# ---------------------------------------------------------------------------
# the JAX tests/test_control_flow.py programs
# ---------------------------------------------------------------------------

def _while_scalar_accumulation(fluid):
    layers = fluid.layers
    limit = layers.fill_constant(shape=[1], dtype='int64', value=10)
    i = layers.zeros(shape=[1], dtype='int64')
    acc = layers.zeros(shape=[1], dtype='float32')
    cond = layers.less_than(x=i, y=limit)
    w = layers.While(cond=cond)
    with w.block():
        fi = layers.cast(i, 'float32')
        new_acc = layers.elementwise_add(acc, fi)
        layers.assign(new_acc, output=acc)
        layers.increment(x=i, in_place=True)
        layers.less_than(x=i, y=limit, cond=cond)
    return [acc, i], {}


def _while_array_read_write(fluid):
    layers = fluid.layers
    d = np.random.RandomState(0).rand(6, 8).astype('float32')
    x = layers.data(name='x', shape=[6, 8], append_batch_size=False)
    zero = layers.zeros(shape=[1], dtype='int64')
    arr = layers.create_array('float32')
    i = layers.zeros(shape=[1], dtype='int64')
    n = layers.fill_constant(shape=[1], dtype='int64', value=6)
    cond = layers.less_than(x=i, y=n)
    w0 = layers.While(cond=cond)
    row0 = layers.slice(x, axes=[0], starts=[0], ends=[1])
    row0 = layers.reshape(row0, shape=[8])
    layers.array_write(row0, i=zero, array=arr)
    with w0.block():
        row = layers.reshape(layers.gather(x, layers.cast(i, 'int32')),
                             shape=[8])
        layers.array_write(row, i=i, array=arr)
        layers.increment(x=i, in_place=True)
        layers.less_than(x=i, y=n, cond=cond)
    j = layers.zeros(shape=[1], dtype='int64')
    total = layers.zeros(shape=[8], dtype='float32')
    cond2 = layers.less_than(x=j, y=n)
    w1 = layers.While(cond=cond2)
    with w1.block():
        v = layers.array_read(arr, i=j)
        s = layers.elementwise_add(total, v)
        layers.assign(s, output=total)
        layers.increment(x=j, in_place=True)
        layers.less_than(x=j, y=n, cond=cond2)
    length = layers.array_length(arr)
    return [total, length], {'x': d}


def _while_max_iters_backward(fluid):
    layers = fluid.layers
    x = layers.data(name='x', shape=[4], append_batch_size=False,
                    stop_gradient=False)
    w = layers.create_parameter(
        shape=[4], dtype='float32',
        default_initializer=fluid.initializer.Constant(2.0))
    limit = layers.fill_constant(shape=[1], dtype='int64', value=3)
    i = layers.zeros(shape=[1], dtype='int64')
    acc = layers.ones(shape=[4], dtype='float32')
    acc.stop_gradient = False
    cond = layers.less_than(x=i, y=limit)
    loop = layers.While(cond=cond, max_iters=8)
    with loop.block():
        nxt = layers.elementwise_mul(acc, w)
        layers.assign(nxt, output=acc)
        layers.increment(x=i, in_place=True)
        layers.less_than(x=i, y=limit, cond=cond)
    y = layers.elementwise_mul(acc, x)
    loss = layers.reduce_mean(y)
    fluid.optimizer.SGD(learning_rate=0.0).minimize(loss)
    return [loss, w.name + '@GRAD'], {'x': np.arange(4).astype('float32')}


def _ifelse_merge(fluid):
    layers = fluid.layers
    xv = np.random.RandomState(1).randn(6, 1).astype('float32')
    x = layers.data(name='x', shape=[1])
    zero = layers.fill_constant_batch_size_like(x, shape=[-1, 1],
                                                dtype='float32', value=0.0)
    cond = layers.less_than(x=zero, y=x)
    ie = layers.IfElse(cond)
    with ie.true_block():
        t = ie.input(x)
        ie.output(layers.scale(t, scale=2.0))
    with ie.false_block():
        f = ie.input(x)
        ie.output(layers.scale(f, scale=-1.0))
    merged = ie()[0]
    return [merged], {'x': xv}


def _switch(step_val):
    def build(fluid):
        layers = fluid.layers
        step = layers.data(name='step', shape=[1], append_batch_size=False,
                           dtype='int64')
        five = layers.fill_constant(shape=[1], dtype='int64', value=5)
        lr = layers.fill_constant(shape=[1], dtype='float32', value=0.0)
        cond = layers.less_than(x=step, y=five)
        with layers.Switch() as switch:
            with switch.case(cond):
                layers.assign(np.array([1.0], dtype='float32'), output=lr)
            with switch.default():
                layers.assign(np.array([0.1], dtype='float32'), output=lr)
        return [lr], {'step': np.array([step_val], dtype='int64')}
    return build


def _static_rnn_cumsum(fluid):
    layers = fluid.layers
    T, B, D = 5, 3, 4
    xv = np.random.RandomState(2).randn(T, B, D).astype('float32')
    x = layers.data(name='x', shape=[T, B, D], append_batch_size=False)
    rnn = layers.StaticRNN()
    with rnn.step():
        x_t = rnn.step_input(x)
        prev = rnn.memory(shape=[D], batch_ref=x_t)
        h = layers.elementwise_add(x_t, prev)
        rnn.update_memory(prev, h)
        rnn.step_output(h)
    return [rnn()], {'x': xv}


def _static_rnn_fc_backward(fluid):
    layers = fluid.layers
    T, B, D, H = 4, 2, 3, 5
    xv = np.random.RandomState(3).randn(T, B, D).astype('float32')
    x = layers.data(name='x', shape=[T, B, D], append_batch_size=False)
    rnn = layers.StaticRNN()
    with rnn.step():
        x_t = rnn.step_input(x)
        prev = rnn.memory(shape=[H], batch_ref=x_t)
        h = layers.fc(input=[x_t, prev], size=H, act='tanh')
        rnn.update_memory(prev, h)
        rnn.step_output(h)
    out_seq = rnn()
    loss = layers.reduce_mean(out_seq)
    fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return [loss, out_seq], {'x': xv}


def _dynamic_rnn_masked_cumsum(fluid):
    layers = fluid.layers
    D = 2
    lengths = [5, 3, 1]
    flat = np.random.RandomState(4).randn(sum(lengths), D).astype('float32')
    lt = fluid.create_lod_tensor(flat, [lengths], fluid.CPUPlace())
    x = layers.data(name='x', shape=[D], lod_level=1)
    drnn = layers.DynamicRNN()
    with drnn.block():
        x_t = drnn.step_input(x)
        mem = drnn.memory(shape=[D], value=0.0)
        h = layers.elementwise_add(x_t, mem)
        drnn.update_memory(mem, h)
        drnn.output(h)
    last = layers.sequence_last_step(drnn())
    return [last], {'x': lt}


def _array_ops_outside_loop(fluid):
    layers = fluid.layers
    v1 = layers.fill_constant(shape=[3], dtype='float32', value=1.0)
    v2 = layers.fill_constant(shape=[3], dtype='float32', value=2.0)
    i0 = layers.zeros(shape=[1], dtype='int64')
    i1 = layers.fill_constant(shape=[1], dtype='int64', value=1)
    arr = layers.array_write(v1, i=i0)
    layers.array_write(v2, i=i1, array=arr)
    r = layers.array_read(arr, i=i1)
    n = layers.array_length(arr)
    return [r, n], {}


def _ifelse_outer_write(xval):
    def build(fluid):
        layers = fluid.layers
        x = layers.data(name='x', shape=[1], append_batch_size=False)
        zero = layers.fill_constant(shape=[1], dtype='float32', value=0.0)
        flag = layers.fill_constant(shape=[1], dtype='float32', value=-1.0)
        cond = layers.less_than(x=zero, y=x)
        ie = layers.IfElse(cond)
        with ie.true_block():
            t = ie.input(x)
            layers.assign(layers.scale(t, scale=10.0), output=flag)
            ie.output(t)
        with ie.false_block():
            f = ie.input(x)
            ie.output(f)
        ie()
        return [flag], {'x': np.array([xval], 'float32')}
    return build


def test_while_scalar_accumulation():
    _, (acc, i) = _both(_while_scalar_accumulation)
    assert float(acc[0]) == sum(range(10)) and int(i[0]) == 10


def test_while_array_read_write():
    d = np.random.RandomState(0).rand(6, 8).astype('float32')
    _, (total, length) = _both(_while_array_read_write)
    np.testing.assert_allclose(total, d.sum(0), rtol=1e-5)
    assert int(length[0]) == 6


def test_while_max_iters_backward():
    _, (loss, g) = _both(_while_max_iters_backward)
    xv = np.arange(4).astype('float32')
    np.testing.assert_allclose(loss.reshape(()), np.mean(xv * 8.0), rtol=1e-5)
    np.testing.assert_allclose(g, 3 * 4.0 * xv / 4, rtol=1e-5)


def test_ifelse_merge():
    xv = np.random.RandomState(1).randn(6, 1).astype('float32')
    _, (merged,) = _both(_ifelse_merge)
    np.testing.assert_allclose(merged, np.where(xv > 0, 2 * xv, -xv),
                               rtol=1e-6)


@pytest.mark.parametrize('step_val,expect', [(3, 1.0), (7, 0.1)])
def test_switch(step_val, expect):
    _, (lr,) = _both(_switch(step_val))
    assert abs(float(lr[0]) - expect) < 1e-6


def test_static_rnn_cumsum():
    xv = np.random.RandomState(2).randn(5, 3, 4).astype('float32')
    _, (out,) = _both(_static_rnn_cumsum)
    np.testing.assert_allclose(out, np.cumsum(xv, axis=0), rtol=1e-5)


def test_static_rnn_fc_backward():
    """Three SGD steps from the JAX startup weights: losses and outputs
    of every step within TOL."""
    _both(_static_rnn_fc_backward, steps=3, carry_state=True)


def test_dynamic_rnn_masked_cumsum():
    lengths = [5, 3, 1]
    flat = np.random.RandomState(4).randn(sum(lengths), 2).astype('float32')
    _, (last,) = _both(_dynamic_rnn_masked_cumsum)
    off = np.cumsum([0] + lengths)
    want = np.stack([flat[off[i]:off[i + 1]].sum(0) for i in range(3)])
    np.testing.assert_allclose(last, want, rtol=1e-5)


def test_array_ops_outside_loop():
    _, (r, n) = _both(_array_ops_outside_loop)
    np.testing.assert_allclose(r, np.full(3, 2.0))
    assert int(n[0]) == 2


@pytest.mark.parametrize('xval,expect', [(2.0, 20.0), (-2.0, -1.0)])
def test_ifelse_outer_write_merged(xval, expect):
    _, (flag,) = _both(_ifelse_outer_write(xval))
    assert float(flag[0]) == expect


def _loop_dropout(fluid):
    layers = fluid.layers
    T, B, D = 6, 2, 64
    x = layers.data(name='x', shape=[T, B, D], append_batch_size=False)
    rnn = layers.StaticRNN()
    with rnn.step():
        x_t = rnn.step_input(x)
        prev = rnn.memory(shape=[D], batch_ref=x_t)
        h = layers.dropout(x_t, dropout_prob=0.5)
        rnn.update_memory(prev, h)
        rnn.step_output(h)
    return [rnn()], {'x': np.ones((T, B, D), 'float32')}


def test_loop_dropout_varies_per_step():
    """The same program in both packages; in each the masks differ from
    one iteration to the next (the bits differ between the packages)."""
    for pkg in (JAX, PORT):
        main, (out,), _ = _run(pkg, _loop_dropout)
        out = out[0]
        masks = (out != 0).reshape(6, -1)
        assert any(not np.array_equal(masks[0], masks[t])
                   for t in range(1, 6))
        assert 0.3 < masks.mean() < 0.7
    _assert_same_program(_run(JAX, _loop_dropout)[0],
                         _run(PORT, _loop_dropout)[0])


# ---------------------------------------------------------------------------
# the book decoder's idiom: the While capacity widening for LoD beam arrays
# ---------------------------------------------------------------------------

B_BEAM, K_BEAM, V_BEAM = 2, 2, 12


def _lod_beam_decoder(fluid):
    layers = fluid.layers
    B, K, V = B_BEAM, K_BEAM, V_BEAM
    init_ids = layers.data(name='init_ids', shape=[1], dtype='int64',
                           lod_level=2)
    init_scores = layers.data(name='init_scores', shape=[1],
                              dtype='float32', lod_level=2)
    layers.create_parameter([V, 8], 'float32', name='bm_emb')
    counter = layers.zeros(shape=[1], dtype='int64', force_cpu=True)
    max_len = layers.fill_constant(shape=[1], dtype='int64', value=4)
    ids_arr = layers.create_array('int64')
    sc_arr = layers.create_array('float32')
    layers.array_write(init_ids, array=ids_arr, i=counter)
    layers.array_write(init_scores, array=sc_arr, i=counter)
    cond = layers.less_than(x=counter, y=max_len)
    w = layers.While(cond=cond)
    with w.block():
        pre_ids = layers.array_read(array=ids_arr, i=counter)
        pre_sc = layers.array_read(array=sc_arr, i=counter)
        emb = layers.embedding(pre_ids, size=[V, 8],
                               param_attr=fluid.ParamAttr(name='bm_emb'))
        score = layers.fc(input=emb, size=V, num_flatten_dims=2,
                          act='softmax')
        tk_sc, tk_idx = layers.topk(score, k=K)
        accu = layers.elementwise_add(
            x=layers.log(tk_sc),
            y=layers.reshape(pre_sc, shape=[-1]), axis=0)
        sel_ids, sel_sc = layers.beam_search(
            pre_ids, pre_sc, tk_idx, accu, K, end_id=0, level=0)
        layers.increment(x=counter, value=1, in_place=True)
        layers.array_write(sel_ids, array=ids_arr, i=counter)
        layers.array_write(sel_sc, array=sc_arr, i=counter)
        layers.logical_and(
            x=layers.less_than(x=counter, y=max_len),
            y=layers.logical_not(layers.is_empty(x=sel_ids)), out=cond)
    tr_ids, tr_sc = layers.beam_search_decode(ids_arr, sc_arr, beam_size=K,
                                              end_id=0)
    feed = {
        'init_ids': fluid.create_lod_tensor(
            np.ones((B, 1), 'int64'), [[1] * B, [1] * B], fluid.CPUPlace()),
        'init_scores': fluid.create_lod_tensor(
            np.ones((B, 1), 'float32'), [[1] * B, [1] * B],
            fluid.CPUPlace()),
    }
    return [tr_ids, tr_sc], feed


def _assert_same_lod(got, want):
    assert got.recursive_sequence_lengths() == \
        want.recursive_sequence_lengths()
    _close(np.asarray(got.data), np.asarray(want.data))


def test_while_capacity_widening_for_lod_beam_arrays():
    """The decode idiom: one row a source written before a While whose
    body writes beam_size rows a source. The port's 2-level LoD and ids
    equal the JAX package's, scores within TOL; the program is the JAX
    program op for op, survives the desc round trip, and the JAX desc run
    by the port gives the same sentences."""
    jmain, (jout,), jinit = _run(JAX, _lod_beam_decoder,
                                 return_numpy=False)
    tmain, (tout,), _ = _run(PORT, _lod_beam_decoder, state=jinit,
                             return_numpy=False)
    _assert_same_program(jmain, tmain)
    for t, j in zip(tout, jout):
        _assert_same_lod(t, j)
    lens = tout[0].recursive_sequence_lengths()
    assert len(lens) == 2 and len(lens[0]) == B_BEAM
    assert all(1 <= h <= K_BEAM for h in lens[0])
    assert sum(lens[1]) == np.asarray(tout[0].data).shape[0]
    # the desc round trip in the port, and the JAX desc run by the port
    fetch, feed = _feed_only(_lod_beam_decoder)
    for desc in (tmain._to_dict(), jmain._to_dict()):
        main2 = tframework.Program._from_dict(desc)
        assert main2._to_dict() == tframework.Program._from_dict(
            main2._to_dict())._to_dict()
        scope = tfluid.Scope()
        scope.load_numpy(jinit, tfluid.CPUPlace())
        got = tfluid.Executor(tfluid.CPUPlace()).run(
            main2, feed=feed, fetch_list=[v.name for v in fetch],
            scope=scope, return_numpy=False)
        for t, j in zip(got, jout):
            _assert_same_lod(t, j)


def _feed_only(build):
    """build(fluid)'s fetch vars and feed, from a throwaway port program."""
    main, startup = tframework.Program(), tframework.Program()
    with tunique.guard(), tframework.program_guard(main, startup):
        return build(tfluid)


# ---------------------------------------------------------------------------
# the port's own behaviour
# ---------------------------------------------------------------------------

def _overrun(max_iters=None, capacity=None):
    def build(fluid):
        layers = fluid.layers
        limit = layers.fill_constant(shape=[1], dtype='int64', value=20)
        i = layers.zeros(shape=[1], dtype='int64')
        cond = layers.less_than(x=i, y=limit)
        if capacity is not None:
            arr = layers.create_array('int64', capacity=capacity)
            layers.array_write(i, i=i, array=arr)
        w = layers.While(cond=cond, max_iters=max_iters)
        with w.block():
            layers.increment(x=i, in_place=True)
            if capacity is not None:
                layers.array_write(i, i=i, array=arr)
            layers.less_than(x=i, y=limit, cond=cond)
        if capacity is None:
            return [i], {}
        return [i, layers.array_length(arr)], {}
    return build


@pytest.mark.parametrize('max_iters,capacity,bound', [
    (5, None, 5), (None, 8, 8), (None, None, None)])
def test_while_past_its_bound_raises(max_iters, capacity, bound):
    """A loop of 20 iterations under a bound of 5 (max_iters) or 8 (the
    array's capacity) raises, naming the op, its bound and the remedy;
    under the default bound (128) it runs to its end."""
    if bound is None:
        _, (out,), _ = _run(PORT, _overrun())
        assert int(out[0][0]) == 20
        return
    # past the capacity the write clamps to the last slot; the CPU walk
    # knows the index and warns (the JAX package prints from the device)
    warns = pytest.warns(UserWarning, match='capacity 8') if capacity \
        else contextlib.nullcontext()
    with pytest.raises(RuntimeError) as e, warns:
        _run(PORT, _overrun(max_iters, capacity))
    msg = str(e.value)
    assert 'while op #' in msg and 'bound of %d' % bound in msg
    assert 'max_iters' in msg and 'capacity' in msg
    # with room enough it runs to its end
    _, (out,), _ = _run(PORT, _overrun(max_iters and 32,
                                       capacity and 32))
    assert int(out[0][0]) == 20
    if capacity:
        assert int(out[1][0]) == 21


def test_print_returns_its_input(capsys):
    def build(fluid):
        x = fluid.layers.data(name='x', shape=[3], append_batch_size=False)
        y = fluid.layers.Print(x, message='the x')
        return [y], {'x': np.arange(3).astype('float32')}
    _, (out,), _ = _run(PORT, build)
    np.testing.assert_array_equal(out[0], np.arange(3))
    assert 'the x' in capsys.readouterr().out


@pytest.mark.parametrize('bad', [None, np.nan, np.inf])
def test_isfinite(bad):
    def build(fluid):
        x = fluid.layers.data(name='x', shape=[3], append_batch_size=False)
        y = fluid.layers.data(name='y', shape=[2], append_batch_size=False)
        helper = fluid.layer_helper.LayerHelper('isfinite')
        out = helper.create_variable_for_type_inference(dtype='bool')
        helper.append_op(type='isfinite', inputs={'X': [x, y]},
                         outputs={'Out': [out]})
        xv = np.arange(3).astype('float32')
        if bad is not None:
            xv[1] = bad
        return [out], {'x': xv, 'y': np.ones(2, 'float32')}
    j, t = _both(build)
    assert bool(t[0]) == (bad is None)


def test_is_empty_dense():
    def build(fluid):
        x = fluid.layers.data(name='x', shape=[3], append_batch_size=False)
        return [fluid.layers.is_empty(x)], {'x': np.ones(3, 'float32')}
    _, (out,) = _both(build)
    assert not bool(out)


def test_reorder_and_parallel_do():
    x = object()
    assert tfluid.layers.reorder_lod_tensor_by_rank(x, None) is x
    with pytest.raises(NotImplementedError):
        tfluid.layers.ParallelDo()


def test_layers_export_the_jax_control_flow_names():
    from paddle_tpu.fluid.layers import control_flow as jcf
    for name in jcf.__all__ + ['beam_search', 'beam_search_decode']:
        assert hasattr(tfluid.layers, name), name
        assert name in tfluid.layers.__all__, name


# ---------------------------------------------------------------------------
# the book's While-loop LoD beam decoder (test_machine_translation.py
# decode_main), at tiny widths
# ---------------------------------------------------------------------------

BOOK = dict(dict_size=40, word_dim=8, hidden=8, beam=2, max_len=6,
            end_id=1)
BOOK_SOURCES = [[5, 9, 3, 7], [12, 4], [30, 31, 32, 2, 6, 8], [17]]


def _book_decoder(fluid, dict_size, word_dim, hidden, beam, max_len, end_id):
    """The book's encoder (embedding, fc 4 x hidden tanh, dynamic_lstm, last
    step) and decode(): state, ids and scores arrays of the default
    capacity, sequence_expand and lod_reset on the beam form, fc tanh state,
    fc softmax, topk, log + accumulate, beam_search (level 0), an is_empty
    stop, beam_search_decode over the arrays."""
    layers = fluid.layers
    src = layers.data(name='src_word_id', shape=[1], dtype='int64',
                      lod_level=1)
    emb = layers.embedding(input=src, size=[dict_size, word_dim],
                           dtype='float32',
                           param_attr=fluid.ParamAttr(name='vemb'))
    fc1 = layers.fc(input=emb, size=hidden * 4, act='tanh')
    h, _ = layers.dynamic_lstm(input=fc1, size=hidden * 4)
    context = layers.sequence_last_step(input=h)

    array_len = layers.fill_constant(shape=[1], dtype='int64',
                                     value=max_len)
    counter = layers.zeros(shape=[1], dtype='int64', force_cpu=True)
    state_array = layers.create_array('float32')
    layers.array_write(context, array=state_array, i=counter)
    ids_array = layers.create_array('int64')
    scores_array = layers.create_array('float32')
    init_ids = layers.data(name='init_ids', shape=[1], dtype='int64',
                           lod_level=2)
    init_scores = layers.data(name='init_scores', shape=[1],
                              dtype='float32', lod_level=2)
    layers.array_write(init_ids, array=ids_array, i=counter)
    layers.array_write(init_scores, array=scores_array, i=counter)
    cond = layers.less_than(x=counter, y=array_len)
    while_op = layers.While(cond=cond)
    with while_op.block():
        pre_ids = layers.array_read(array=ids_array, i=counter)
        pre_state = layers.array_read(array=state_array, i=counter)
        pre_score = layers.array_read(array=scores_array, i=counter)
        pre_state_expanded = layers.sequence_expand(pre_state, pre_score)
        pre_ids_emb = layers.embedding(input=pre_ids,
                                       size=[dict_size, word_dim],
                                       dtype='float32')
        current_state = layers.fc(input=[pre_state_expanded, pre_ids_emb],
                                  size=hidden, act='tanh')
        current_state_with_lod = layers.lod_reset(x=current_state,
                                                  y=pre_score)
        current_score = layers.fc(input=current_state_with_lod,
                                  size=dict_size, act='softmax')
        topk_scores, topk_indices = layers.topk(current_score, k=beam)
        accu_scores = layers.elementwise_add(
            x=layers.log(topk_scores),
            y=layers.reshape(pre_score, shape=[-1]), axis=0)
        selected_ids, selected_scores = layers.beam_search(
            pre_ids, pre_score, topk_indices, accu_scores, beam,
            end_id=end_id, level=0)
        layers.increment(x=counter, value=1, in_place=True)
        layers.array_write(current_state, array=state_array, i=counter)
        layers.array_write(selected_ids, array=ids_array, i=counter)
        layers.array_write(selected_scores, array=scores_array, i=counter)
        length_cond = layers.less_than(x=counter, y=array_len)
        finish_cond = layers.logical_not(layers.is_empty(x=selected_ids))
        layers.logical_and(x=length_cond, y=finish_cond, out=cond)
    ids, scores = layers.beam_search_decode(
        ids=ids_array, scores=scores_array, beam_size=beam, end_id=end_id)
    return ids, scores, counter


def _book_feed(fluid, sources):
    n = len(sources)
    flat = np.concatenate(sources).reshape(-1, 1).astype('int64')
    return {
        'src_word_id': fluid.create_lod_tensor(
            flat, [[len(s) for s in sources]], fluid.CPUPlace()),
        'init_ids': fluid.create_lod_tensor(
            np.zeros((n, 1), 'int64'), [[1] * n, [1] * n], fluid.CPUPlace()),
        'init_scores': fluid.create_lod_tensor(
            np.ones((n, 1), 'float32'), [[1] * n, [1] * n],
            fluid.CPUPlace()),
    }


@pytest.mark.parametrize('end_id,max_len', [(1, 6), (7, 9)])
def test_book_decoder(end_id, max_len):
    """decode_main at tiny widths from the JAX startup weights: the port's
    program is the JAX program op for op, and its sentences (2-level LoD
    and ids equal, scores within TOL) and live iterations are the JAX
    package's."""
    cfg = dict(BOOK, end_id=end_id, max_len=max_len)

    def build(fluid):
        ids, scores, counter = _book_decoder(fluid, **cfg)
        return [ids, scores, counter], _book_feed(fluid, BOOK_SOURCES)
    jmain, (jout,), jinit = _run(JAX, build, return_numpy=False)
    tmain, (tout,), _ = _run(PORT, build, state=jinit, return_numpy=False)
    _assert_same_program(jmain, tmain)
    _assert_same_lod(tout[0], jout[0])
    _assert_same_lod(tout[1], jout[1])
    _close(np.asarray(tout[2]), np.asarray(jout[2]))
    lens = tout[0].recursive_sequence_lengths()
    assert len(lens[0]) == len(BOOK_SOURCES)
    assert 1 <= int(np.asarray(tout[2])[0]) <= max_len


def test_clone_and_prune_keep_the_block_ops():
    """Program.clone (for_test too) resolves a sub-block op's vars through
    its ancestors, and prune at the decoder's outputs keeps the while op
    that computes them (it lists its outer reads in X): both run to the
    sentences of the program itself."""
    cfg = dict(BOOK)

    def build(fluid):
        ids, scores, counter = _book_decoder(fluid, **cfg)
        return [ids, scores], _book_feed(fluid, BOOK_SOURCES)
    main, (want,), init = _run(PORT, build, return_numpy=False)
    fetch, feed = _feed_only(build)
    names = [v.name for v in fetch]
    for prog in (main.clone(), main.clone(for_test=True),
                 main.prune([main.global_block().var(n) for n in names])):
        assert [op.type for op in prog.global_block().ops].count('while') \
            == 1
        assert prog.num_blocks == main.num_blocks
        scope = tfluid.Scope()
        scope.load_numpy(init, tfluid.CPUPlace())
        got = tfluid.Executor(tfluid.CPUPlace()).run(
            prog, feed=feed, fetch_list=names, scope=scope,
            return_numpy=False)
        for t, w in zip(got, want):
            _assert_same_lod(t, w)


def test_nested_lod_of_length_one_keeps_a_time_axis_of_one():
    """The decode idiom's 2-level init_ids / init_scores (every innermost
    sequence of length 1) keep a time axis of 1, as the JAX package pads
    them and as the beam ops recognize them, through the Executor and the
    DataFeeder alike; other feeds keep the power-of-two bucket."""
    from paddle_tpu_torch.fluid.data_feeder import seq_pad
    assert seq_pad([[1, 1, 1], [1, 1, 1]]) == 1
    assert seq_pad([[2, 1], [1, 1, 1]]) == 1
    assert seq_pad([[1, 1]]) == 8             # one level: the bucket
    assert seq_pad([[1, 1], [1, 2]]) == 8
    assert seq_pad([[3, 9, 17]]) == 32
    main, startup = tframework.Program(), tframework.Program()
    with tunique.guard(), tframework.program_guard(main, startup):
        x = tfluid.layers.data(name='x', shape=[1], dtype='int64',
                               lod_level=2)
    exe = tfluid.Executor(tfluid.CPUPlace())
    lt = tfluid.create_lod_tensor(np.ones((3, 1), 'int64'),
                                  [[2, 1], [1, 1, 1]], tfluid.CPUPlace())
    sv = exe._feed_value(lt, x)
    assert tuple(sv.data.shape) == (3, 1, 1)
    assert sv.outer_lengths[0].tolist() == [2, 1]
    fed = tfluid.DataFeeder([x], tfluid.CPUPlace(), program=main).feed(
        [([[1], [2]],), ([[3]],)])['x']
    assert tuple(fed.data.shape) == (3, 1, 1)
    assert fed.lengths.tolist() == [1, 1, 1]
