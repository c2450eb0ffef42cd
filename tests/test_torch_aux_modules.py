"""The fluid aux modules of the port (annotations, concurrency,
default_scope_funcs, graphviz, net_drawer, debugger's graph helpers,
layers.device, version) and the small names (io.get_inference_program,
models.model_list / get_model_module, the re-exports of fluid and
serving), against the JAX package's on the CPU. The JAX
tests/test_misc_modules.py (:15-98, :166-200, :241) and
tests/test_concurrency.py are the floor: each of their checks runs here
on both packages, and where a module emits text (dot files, the
templated docs) the port's is the JAX package's.
"""
import os
import threading

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import framework as jframework
from paddle_tpu.fluid import unique_name as junique

import paddle_tpu_torch
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import framework as tframework
from paddle_tpu_torch.fluid import unique_name as tunique

from test_torch_training import _normalized

BOTH = [pytest.param(jfluid, id='jax'), pytest.param(tfluid, id='port')]


@pytest.mark.parametrize('fluid', BOTH)
def test_deprecated_decorator(fluid, capsys):
    @fluid.annotations.deprecated(since='0.14', instead='new_api')
    def old_api(x):
        return x + 1
    assert old_api(1) == 2
    err = capsys.readouterr().err
    assert 'deprecated' in err and 'new_api' in err
    assert 'Warning' in old_api.__doc__


@pytest.mark.parametrize('fluid', BOTH)
def test_default_scope_funcs(fluid):
    d = fluid.default_scope_funcs
    root = d.get_cur_scope()
    assert isinstance(root, fluid.Scope)
    d.var('x').set(42)
    assert d.find_var('x').get() == 42 and d.find_var('x').name() == 'x'
    d.enter_local_scope()
    assert d.get_cur_scope() is not root
    assert d.find_var('x').get() == 42      # falls back to the parent
    d.var('y').set(7)
    d.leave_local_scope()
    assert d.get_cur_scope() is root
    assert d.find_var('y') is None          # gone with its scope
    d.leave_local_scope()                   # the root is never popped
    assert d.get_cur_scope() is root
    d.scoped_function(lambda: d.var('tmp').set(1))
    assert d.find_var('tmp') is None


def test_default_scope_stack_is_per_thread():
    d = tfluid.default_scope_funcs
    mine = d.get_cur_scope()
    seen = []
    t = threading.Thread(target=lambda: seen.append(d.get_cur_scope()))
    t.start()
    t.join(timeout=10)
    assert not t.is_alive() and seen[0] is not mine


def test_the_port_runs_under_a_child_scope():
    """Parameters initialized in a parent scope resolve, and update in
    place, when a step runs under a child scope (the JAX
    test_executor_runs_under_child_scope)."""
    main, startup = tframework.Program(), tframework.Program()
    parent = tfluid.Scope()
    with tunique.guard(), tframework.program_guard(main, startup):
        x = tfluid.layers.data(name='x', shape=[3], dtype='float32')
        y = tfluid.layers.data(name='y', shape=[1], dtype='float32')
        pred = tfluid.layers.fc(input=x, size=1)
        cost = tfluid.layers.mean(
            tfluid.layers.square_error_cost(input=pred, label=y))
        tfluid.optimizer.SGD(learning_rate=0.5).minimize(cost)
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=parent)
    wname = [n for n in parent.vars if n.endswith('.w_0')][0]
    before = parent.to_numpy([wname])[wname]
    child = parent.new_scope()
    assert wname in child
    exe.run(main, feed={'x': np.ones((4, 3), 'float32'),
                        'y': np.zeros((4, 1), 'float32')},
            fetch_list=[cost], scope=child)
    assert not np.allclose(before, parent.to_numpy([wname])[wname])
    assert wname not in child.vars


def _graphs(graphviz, tmp_path, tag):
    graphviz.Node.counter = 0
    g = graphviz.Graph('T', rankdir='TB')
    a = g.add_node('A', shape='rect')
    b = g.add_node('B')
    g.add_edge(a, b, label='ab')
    p = str(tmp_path / ('%s_g.dot' % tag))
    image = g.compile(p)
    gen = graphviz.GraphPreviewGenerator('prev')
    pn = gen.add_param('w', 'float32', highlight=True)
    on = gen.add_op('matmul')
    an = gen.add_arg('x')
    gen.add_edge(pn, on)
    gen.add_edge(an, on)
    out = gen(str(tmp_path / ('%s_prev.dot' % tag)))
    return str(g), image, open(p).read(), out, str(gen.graph)


def test_graphviz_emits_the_jax_text(tmp_path):
    j = _graphs(jfluid.graphviz, tmp_path, 'j')
    t = _graphs(tfluid.graphviz, tmp_path, 't')
    assert 'digraph G' in t[0] and '->' in t[0] and 'label="ab"' in t[0]
    assert t[1] == str(tmp_path / 't_g.png')
    assert t[0] == j[0] and t[2] == j[2] and t[4] == j[4]
    assert os.path.exists(str(tmp_path / 't_prev.dot'))


def _program(pkg):
    fluid, framework, unique_name = pkg
    main, startup = framework.Program(), framework.Program()
    with unique_name.guard(), framework.program_guard(main, startup):
        x = fluid.layers.data(name='x', shape=[4], dtype='float32')
        y = fluid.layers.fc(input=x, size=2, act='relu')
        loss = fluid.layers.mean(y)
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss


JAX = (jfluid, jframework, junique)
PORT = (tfluid, tframework, tunique)


def test_net_drawer_draws_the_jax_graph(tmp_path):
    texts = []
    for pkg, tag in ((JAX, 'j'), (PORT, 't')):
        main, startup, _ = _program(pkg)
        pkg[0].graphviz.Node.counter = 0
        path = str(tmp_path / ('%s_net.dot' % tag))
        assert pkg[0].net_drawer.draw_graph(startup, main, path=path) == path
        texts.append(open(path).read())
    assert 'mul' in texts[1] and 'x' in texts[1]
    assert texts[1] == texts[0]


def test_debugger_graph_helpers_emit_the_jax_text(tmp_path, capsys):
    texts = []
    for pkg, tag in ((JAX, 'j'), (PORT, 't')):
        main, _, _ = _program(pkg)
        path = str(tmp_path / ('%s_block.dot' % tag))
        assert pkg[0].debugger.draw_block_graphviz(
            main.global_block(), highlights=['mul'], path=path) == path
        texts.append(open(path).read())
    assert texts[1] == texts[0]
    assert 'fillcolor=red' in texts[1] and 'op0 -> var_' in texts[1]
    main, _, _ = _program(PORT)
    tfluid.debugger.pprint_program_codes(main)
    assert capsys.readouterr().out.strip() == main.to_string().strip()


# -- concurrency (the JAX tests/test_concurrency.py) ---------------------------

@pytest.mark.parametrize('fluid', BOTH)
def test_buffered_channel_send_recv(fluid):
    ch = fluid.make_channel(dtype='int64', capacity=10)
    for i in range(5):
        assert fluid.channel_send(ch, i)
    assert [fluid.channel_recv(ch)[0] for _ in range(5)] == [0, 1, 2, 3, 4]


@pytest.mark.parametrize('fluid', BOTH)
def test_channel_close_semantics(fluid):
    ch = fluid.make_channel(dtype='int64', capacity=4)
    fluid.channel_send(ch, 7)
    fluid.channel_close(ch)
    assert fluid.channel_recv(ch) == (7, True)    # buffered values drain
    assert fluid.channel_recv(ch) == (None, False)
    assert fluid.channel_recv(ch, return_value=-1) == (-1, False)
    assert not fluid.channel_send(ch, 1)


@pytest.mark.parametrize('fluid', BOTH)
def test_goroutine_pipeline_unbuffered(fluid):
    ch = fluid.make_channel(dtype='int64')       # capacity 0: rendezvous
    result = []

    def producer():
        a, b = 0, 1
        for _ in range(10):
            fluid.channel_send(ch, [a])
            a, b = b, a + b
        fluid.channel_close(ch)

    with fluid.Go() as g:
        g.run(producer)
        while True:
            v, ok = fluid.channel_recv(ch)
            if not ok:
                break
            result.append(v[0])
        g.join(timeout=5)
    assert result == [0, 1, 1, 2, 3, 5, 8, 13, 21, 34]


@pytest.mark.parametrize('fluid', BOTH)
def test_go_with_a_target_and_a_copying_send(fluid):
    ch = fluid.make_channel(dtype='int64', capacity=2)
    payload = [1, 2]
    g = fluid.Go(target=lambda: fluid.channel_send(ch, payload,
                                                   is_copy=True))
    assert g.start() is g
    g.join(timeout=5)
    got, ok = fluid.channel_recv(ch)
    assert ok and got == payload and got is not payload


@pytest.mark.parametrize('fluid', BOTH)
def test_select_recv_send_default_and_timeout(fluid):
    a = fluid.make_channel(dtype='int64', capacity=1)
    b = fluid.make_channel(dtype='int64', capacity=1)
    got = {}
    sel = fluid.Select()
    sel.case(a, 'recv', lambda v: got.setdefault('a', v))
    sel.case(b, 'recv', lambda v: got.setdefault('b', v))
    fluid.channel_send(b, 99)
    assert sel(timeout=5) == 1 and got == {'b': 99}
    empty = fluid.Select()
    empty.case(a, 'recv', lambda v: None)
    empty.default(lambda: got.setdefault('idle', True))
    assert empty() == -1 and got.get('idle')
    fired = []
    send = fluid.Select().case(a, 'send', 5, lambda: fired.append(True))
    assert send(timeout=5) == 0 and fired == [True]
    assert fluid.channel_recv(a) == (5, True)
    with pytest.raises(TimeoutError):
        fluid.Select().case(b, 'recv')(timeout=0.05)
    with pytest.raises(ValueError):
        fluid.Select().case(a, 'poll')


# -- layers.device, version, the small names ----------------------------------

def test_get_places():
    from paddle_tpu.fluid.layers import device as jdevice
    from paddle_tpu_torch.fluid.layers import device as tdevice
    assert tdevice.get_places(3) == jdevice.get_places(3) == [0, 1, 2]
    import torch
    assert tdevice.get_places() == list(range(max(
        torch.cuda.device_count(), 1)))
    assert tdevice.__all__ == jdevice.__all__ == []


def test_version_module():
    import paddle_tpu.version as jv
    import paddle_tpu_torch.version as tv
    assert paddle_tpu_torch.__version__ == tv.full_version
    assert paddle_tpu_torch.__git_commit__ == tv.commit
    assert tv.full_version.startswith('%d.%d.%s' % (tv.major, tv.minor,
                                                    tv.patch))
    for name in ('major', 'minor', 'patch', 'rc', 'version', 'istaged'):
        assert getattr(tv, name) == getattr(jv, name), name
    assert tv.mkl() == 'OFF'
    tv.show()


def test_get_inference_program_is_the_jax_clone():
    got, want = [], []
    for pkg, out in ((JAX, want), (PORT, got)):
        main, _, loss = _program(pkg)
        with pkg[1].program_guard(main):
            out.append(pkg[0].io.get_inference_program(loss))
        out.append(pkg[0].io.get_inference_program([loss], main))
    for g, w in zip(got, want):
        assert _normalized(g) == _normalized(w)
    assert 'sgd' not in [op.type for op in got[0].global_block().ops]


def test_model_list_and_get_model_module():
    from paddle_tpu import models as jmodels
    from paddle_tpu_torch import models as tmodels
    assert tmodels.model_list == jmodels.model_list
    for name in tmodels.model_list:
        mod = tmodels.get_model_module(name)
        assert mod.__name__ == 'paddle_tpu_torch.models.' + name
        assert hasattr(mod, 'get_model'), name
    for models in (jmodels, tmodels):
        with pytest.raises(ValueError, match='unknown model'):
            models.get_model_module('alexnet')


def test_fluid_and_serving_reexport_the_jax_names():
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.serving import pages
    from paddle_tpu_torch.fluid import backward, clip, framework
    from paddle_tpu_torch.fluid.layers import math_op_patch
    assert tfluid.append_backward is backward.append_backward
    for name in ('ErrorClipByValue', 'GradientClipByValue',
                 'GradientClipByNorm', 'GradientClipByGlobalNorm'):
        assert getattr(tfluid, name) is getattr(clip, name)
    assert tfluid.monkey_patch_variable is math_op_patch.monkey_patch_variable
    assert tfluid.name_scope is framework.name_scope
    assert 'name_scope' in framework.__all__
    assert serving.PagePool is pages.PagePool
    assert serving.PrefixCache is pages.PrefixCache
    assert tfluid.Go is tfluid.concurrency.Go
    assert tfluid._switch_scope is tfluid.executor._switch_scope


@pytest.mark.parametrize('fluid', BOTH)
def test_name_scope_nests_and_builds_the_same_program(fluid):
    framework = fluid.framework
    with fluid.name_scope('outer'):
        with fluid.name_scope():
            assert framework._name_scope_stack == ['outer', '']
        assert framework._name_scope_stack == ['outer']
    assert framework._name_scope_stack == []
    with pytest.raises(KeyError):
        with fluid.name_scope('x'):
            raise KeyError('inside')
    assert framework._name_scope_stack == []
