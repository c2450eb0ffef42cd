"""Structured control-flow layers.

Parity: reference python/paddle/fluid/layers/control_flow.py (While:584,
Switch:1067, IfElse:1315, StaticRNN:289, DynamicRNN:1511, the
LoDTensorArray ops, increment/compare ops, Print) and the JAX package's
fluid/layers/control_flow.py, whose programs these layers build op for
op.

The reference runs sub-blocks through C++ interpreter ops (WhileOp /
ConditionalBlockOp / RecurrentOp) with one fresh Scope per iteration.
Here each construct builds a real sub-Block in the Program and appends ONE
block op in the parent; the block op's rule (ops_impl/block_ops.py) runs
the sub-block:

    While      -> a bounded loop of predicated carries, with no host read
                  (the bound: max_iters=, else the least capacity of the
                  arrays it carries; a loop still running at its bound
                  raises after the step)
    StaticRNN  -> a loop over the leading time axis
    DynamicRNN -> a loop over padded [batch, T, ...] + length masking
    IfElse     -> both branches run, outputs merged by predicated select
                  (dense semantics: `ie.input(x)` yields the FULL batch,
                  not the reference's gathered true/false row subsets, a
                  dynamic shape a captured graph cannot hold)
    Switch     -> all cases run, first-true-wins select fold

LoDTensorArray is a fixed-capacity device buffer + live length (see
lowering.ArrayValue), so arrays are legal loop carries.
"""
import contextlib

from .. import unique_name
from ..framework import Variable, default_main_program
from ..layer_helper import LayerHelper
from . import tensor as tensor_mod

__all__ = [
    'While', 'Switch', 'increment', 'array_write', 'create_array',
    'less_than', 'equal', 'array_read', 'array_length', 'IfElse',
    'DynamicRNN', 'StaticRNN', 'reorder_lod_tensor_by_rank', 'ParallelDo',
    'Print', 'is_empty',
]

# Default slot count for LoDTensorArray buffers (overridable per array via
# create_array/array_write capacity=, or globally by assigning this; the
# lowering-side fallback for attr-less ops is lowering.DEFAULT_ARRAY_CAPACITY).
from ..lowering import DEFAULT_ARRAY_CAPACITY as ARRAY_CAPACITY  # noqa: E402


def increment(x, value=1.0, in_place=True):
    helper = LayerHelper("increment", **locals())
    if in_place:
        out = x
    else:
        out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type='increment', inputs={'X': [x]}, outputs={'Out': [out]},
                     attrs={'step': float(value)}, infer_shape=False)
    return out


def less_than(x, y, force_cpu=None, cond=None):
    helper = LayerHelper("less_than", **locals())
    if cond is None:
        cond = helper.create_variable_for_type_inference(dtype='bool')
        cond.stop_gradient = True
    helper.append_op(type='less_than', inputs={'X': [x], 'Y': [y]},
                     outputs={'Out': [cond]})
    return cond


def equal(x, y, cond=None):
    helper = LayerHelper("equal", **locals())
    if cond is None:
        cond = helper.create_variable_for_type_inference(dtype='bool')
        cond.stop_gradient = True
    helper.append_op(type='equal', inputs={'X': [x], 'Y': [y]},
                     outputs={'Out': [cond]})
    return cond


def min_(x, y):
    from .ops import elementwise_min
    return elementwise_min(x, y)


def max_(x, y):
    from .ops import elementwise_max
    return elementwise_max(x, y)


def is_empty(x, cond=None):
    helper = LayerHelper("is_empty", **locals())
    if cond is None:
        cond = helper.create_variable_for_type_inference(dtype='bool')
        cond.stop_gradient = True
    helper.append_op(type='is_empty', inputs={'X': [x]}, outputs={'Out': [cond]})
    return cond


def Print(input, first_n=-1, message=None, summarize=-1,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_lod=True,
          print_phase='both'):
    helper = LayerHelper('print', **locals())
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(type='print', inputs={'In': [input]},
                     outputs={'Out': [out]},
                     attrs={'first_n': first_n, 'summarize': summarize,
                            'message': message or '',
                            'print_phase': print_phase})
    return out


# ---------------------------------------------------------------------------
# Sub-block analysis helpers
# ---------------------------------------------------------------------------

def _outer_written(sub):
    """Vars written by sub-block ops that live in an ancestor block — the
    loop carries / merge targets."""
    seen, out = set(), []
    for op in sub.ops:
        for vs in op.outputs.values():
            for v in vs:
                if v.block.idx != sub.idx and v.name not in seen:
                    seen.add(v.name)
                    out.append(v)
    return out


def _outer_read(sub):
    """Ancestor vars read by sub-block ops (for prune()/clone bookkeeping)."""
    seen, out = set(), []
    for op in sub.ops:
        for vs in op.inputs.values():
            for v in vs:
                if v.block.idx != sub.idx and v.name not in seen:
                    seen.add(v.name)
                    out.append(v)
    return out


# ---------------------------------------------------------------------------
# LoDTensorArray
# ---------------------------------------------------------------------------

def create_array(dtype, capacity=None):
    """reference layers/control_flow.py:create_array (LOD_TENSOR_ARRAY var)."""
    helper = LayerHelper('create_array', **locals())
    arr = helper.create_variable(
        name=unique_name.generate('array'), shape=None, dtype=dtype,
        type='LOD_TENSOR_ARRAY')
    arr._initialized = False
    arr._elem_shape = None
    arr._capacity = capacity or ARRAY_CAPACITY
    return arr


def array_write(x, i, array=None, capacity=None):
    """Write x into array slot i of the fixed-capacity buffer (one slot,
    on the device). reference control_flow.py:array_write."""
    helper = LayerHelper('array_write', **locals())
    if array is None:
        array = create_array(x.dtype, capacity=capacity)
    inputs = {'X': [x], 'I': [i]}
    if getattr(array, '_initialized', True):
        inputs['Array'] = [array]
    helper.append_op(
        type='array_write', inputs=inputs, outputs={'Out': [array]},
        attrs={'capacity': int(capacity or getattr(array, '_capacity',
                                                   ARRAY_CAPACITY))},
        infer_shape=False)
    array._initialized = True
    if getattr(array, '_elem_shape', None) is None:
        array._elem_shape = x.shape
    # lod rides along too: a downstream fc must see a sequence var to
    # pick the per-step (feature-only) parameter shape. max over ALL
    # writes — beam-search arrays are often seeded with a lod-0 init and
    # then filled with sequence step outputs.
    array._elem_lod_level = max(getattr(array, '_elem_lod_level', 0),
                                getattr(x, 'lod_level', 0) or 0)
    return array


def array_read(array, i):
    """reference control_flow.py:array_read."""
    helper = LayerHelper('array_read', **locals())
    out = helper.create_variable_for_type_inference(
        dtype=array.dtype,
        lod_level=getattr(array, '_elem_lod_level', 0))
    out.shape = getattr(array, '_elem_shape', None)
    helper.append_op(type='array_read', inputs={'Array': [array], 'I': [i]},
                     outputs={'Out': [out]}, infer_shape=False)
    return out


def array_length(array):
    """reference control_flow.py:array_length."""
    helper = LayerHelper('array_length', **locals())
    out = helper.create_variable_for_type_inference(dtype='int64')
    out.shape = (1,)
    out.stop_gradient = True
    helper.append_op(type='array_length', inputs={'Array': [array]},
                     outputs={'Out': [out]}, infer_shape=False)
    return out


# ---------------------------------------------------------------------------
# While
# ---------------------------------------------------------------------------

class While(object):
    """reference layers/control_flow.py:584 (WhileOp sub-block interpreter).

    Usage (identical to the reference)::

        i = layers.zeros(shape=[1], dtype='int64')
        cond = layers.less_than(x=i, y=limit)
        w = layers.While(cond=cond)
        with w.block():
            ...                    # ops; must update cond
            layers.less_than(x=i, y=limit, cond=cond)

    Loop state = every ancestor var written inside the block (arrays
    included); they must hold values before the loop so carry shapes are
    static. The loop runs a static number of iterations with predicated
    carries (ops_impl/block_ops.py): `max_iters=N` (extension) sets that
    bound; without it the bound is the least capacity of the arrays the
    loop carries, or lowering.DEFAULT_ARRAY_CAPACITY. A loop whose
    condition still holds at its bound raises RuntimeError after the
    step. The loop is differentiable either way.
    """

    def __init__(self, cond, is_test=False, name=None, max_iters=None):
        self.helper = LayerHelper("while", name=name)
        if cond.dtype != 'bool':
            raise TypeError("While condition must be a bool Variable")
        self.cond_var = cond
        self.max_iters = max_iters

    @contextlib.contextmanager
    def block(self):
        main = self.helper.main_program
        parent = main.current_block()
        sub = main.create_block()
        try:
            yield
        finally:
            main.rollback()
        written = _outer_written(sub)
        if self.cond_var.name not in {v.name for v in written} \
                and not self.max_iters:
            import warnings
            warnings.warn("While block never updates its condition %r — the "
                          "loop will not terminate" % self.cond_var.name)
        reads = [v for v in _outer_read(sub)
                 if v.name != self.cond_var.name]
        attrs = {'sub_block': sub.idx}
        if self.max_iters:
            attrs['max_iters'] = int(self.max_iters)
        parent.append_op(
            type='while',
            inputs={'Condition': [self.cond_var], 'X': reads},
            outputs={'Out': written},
            attrs=attrs, infer_shape=False)


# ---------------------------------------------------------------------------
# Switch
# ---------------------------------------------------------------------------

class Switch(object):
    """reference layers/control_flow.py:1067. if/elif/else over scalar bool
    conditions; every case is traced, values merged first-true-wins. Used by
    the learning-rate schedulers exactly like the reference::

        with layers.Switch() as switch:
            with switch.case(step < warmup):
                layers.assign(small_lr, lr)
            with switch.default():
                layers.assign(big_lr, lr)
    """

    def __init__(self, name=None):
        self.helper = LayerHelper('switch', name=name)
        self._cases = []      # (cond_name, sub_idx, [written names], [vars])
        self._reads = []
        self._conds = []

    def __enter__(self):
        return self

    @contextlib.contextmanager
    def _case(self, condition):
        main = self.helper.main_program
        sub = main.create_block()
        try:
            yield
        finally:
            main.rollback()
        written = _outer_written(sub)
        self._cases.append((condition.name if condition is not None else '',
                            sub.idx, [v.name for v in written], written))
        if condition is not None:
            self._conds.append(condition)
        self._reads.extend(_outer_read(sub))

    def case(self, condition):
        return self._case(condition)

    def default(self):
        return self._case(None)

    def __exit__(self, exc_type, exc_val, exc_tb):
        if exc_type is not None:
            return False
        if not self._cases:
            raise ValueError("Switch with no cases")
        defaults = [k for k, c in enumerate(self._cases) if c[0] == '']
        if len(defaults) > 1 or (defaults and
                                 defaults[0] != len(self._cases) - 1):
            raise ValueError("Switch: default() must be the single last case")
        main = self.helper.main_program
        parent = main.current_block()
        union, seen = [], set()
        for _, _, names, vars_ in self._cases:
            for v in vars_:
                if v.name not in seen:
                    seen.add(v.name)
                    union.append(v)
        reads, rseen = [], set()
        for v in self._reads + self._conds:
            if v.name not in rseen and v.name not in seen:
                rseen.add(v.name)
                reads.append(v)
        parent.append_op(
            type='switch',
            inputs={'Conds': self._conds, 'X': reads},
            outputs={'Out': union},
            attrs={'sub_blocks': [c[1] for c in self._cases],
                   'cond_names': [c[0] for c in self._cases],
                   'case_writes': [c[2] for c in self._cases]},
            infer_shape=False)
        return False


# ---------------------------------------------------------------------------
# IfElse
# ---------------------------------------------------------------------------

class IfElse(object):
    """reference layers/control_flow.py:1315.

    Dense-predication semantics: `ie.input(x)` returns the full-batch x in
    both branches (the reference gathers the true/false row subsets, a
    dynamic shape a captured graph cannot hold); both branches execute and
    `ie()` returns where(cond, true, false) per output pair.
    """

    OUT_IF_ELSE_BLOCKS = 2

    def __init__(self, cond, name=None):
        self.helper = LayerHelper('ifelse', name=name)
        if cond.dtype != 'bool':
            raise TypeError("IfElse condition must be a bool Variable")
        self.cond = cond
        self._outs = {True: [], False: []}
        self._blocks = {}
        self._in_branch = None

    @contextlib.contextmanager
    def _branch(self, is_true):
        main = self.helper.main_program
        sub = main.create_block()
        self._in_branch = is_true
        try:
            yield
        finally:
            main.rollback()
            self._in_branch = None
        self._blocks[is_true] = sub

    def true_block(self):
        return self._branch(True)

    def false_block(self):
        return self._branch(False)

    def input(self, x):
        if self._in_branch is None:
            raise ValueError("IfElse.input() must be called inside "
                             "true_block()/false_block()")
        return x

    def output(self, *outs):
        if self._in_branch is None:
            raise ValueError("IfElse.output() must be called inside "
                             "true_block()/false_block()")
        self._outs[self._in_branch].extend(outs)

    def __call__(self):
        if True not in self._blocks or False not in self._blocks:
            raise ValueError("IfElse needs both true_block and false_block")
        t_outs, f_outs = self._outs[True], self._outs[False]
        if len(t_outs) != len(f_outs):
            raise ValueError("IfElse branches must produce the same number "
                             "of outputs (%d vs %d)" % (len(t_outs), len(f_outs)))
        main = self.helper.main_program
        parent = main.current_block()
        merged = []
        for t in t_outs:
            m = parent.create_var(
                name=unique_name.generate(self.helper.name + '.out'),
                shape=t.shape, dtype=t.dtype, lod_level=t.lod_level)
            merged.append(m)
        reads, seen = [], set()
        for sub in (self._blocks[True], self._blocks[False]):
            for v in _outer_read(sub):
                if v.name not in seen and v.name != self.cond.name:
                    seen.add(v.name)
                    reads.append(v)
        # Outer-scope vars written inside a branch (assign(output=...),
        # array_write, ...) merge under the same predicate as the declared
        # outputs — matching Switch, instead of silently dropping them.
        outer_writes, wseen = [], set()
        for sub in (self._blocks[True], self._blocks[False]):
            for v in _outer_written(sub):
                if v.name not in wseen:
                    wseen.add(v.name)
                    outer_writes.append(v)
        parent.append_op(
            type='ifelse',
            inputs={'Cond': [self.cond], 'X': reads},
            outputs={'Out': merged, 'OuterOut': outer_writes},
            attrs={'sub_blocks': [self._blocks[True].idx,
                                  self._blocks[False].idx],
                   'true_outs': [v.name for v in t_outs],
                   'false_outs': [v.name for v in f_outs]},
            infer_shape=False)
        return merged


# ---------------------------------------------------------------------------
# StaticRNN
# ---------------------------------------------------------------------------

class StaticRNN(object):
    """reference layers/control_flow.py:289 (RecurrentOp).

    Steps over the LEADING axis of dense [T, batch, ...] tensors, one
    differentiable loop::

        rnn = layers.StaticRNN()
        with rnn.step():
            x_t = rnn.step_input(x)          # [T,B,D] -> [B,D]
            h_prev = rnn.memory(init=h0)     # or shape=&batch_ref=
            h = layers.fc(input=[x_t, h_prev], size=H)
            rnn.update_memory(h_prev, h)
            rnn.step_output(h)
        outs = rnn()                          # [T,B,H]
    """

    BEFORE_RNN_BLOCK = 0
    IN_RNN_BLOCK = 1
    AFTER_RNN_BLOCK = 2

    def __init__(self, name=None):
        self.helper = LayerHelper("static_rnn", name=name)
        self.status = StaticRNN.BEFORE_RNN_BLOCK
        self.seq_len = None
        self._step_ins = []    # (outer var, inner var)
        self._mems = []        # {'pre': inner, 'init': outer, 'upd': inner}
        self._outs = []        # (inner var, outer var)
        self._sub = None
        self._parent_idx = None

    @contextlib.contextmanager
    def step(self):
        main = self.helper.main_program
        self._parent_idx = main.current_block_idx
        self._sub = main.create_block()
        self.status = StaticRNN.IN_RNN_BLOCK
        try:
            yield
        finally:
            main.rollback()
            self.status = StaticRNN.AFTER_RNN_BLOCK
        self._complete()

    def _assert_in_rnn_block_(self, method):
        if self.status != StaticRNN.IN_RNN_BLOCK:
            raise ValueError("You must invoke {0} in rnn.step()".format(method))

    def step_input(self, x):
        self._assert_in_rnn_block_('step_input')
        if self.seq_len is None:
            self.seq_len = x.shape[0]
        inner = self._sub.create_var(
            name=unique_name.generate(self.helper.name + '.step_in'),
            shape=x.shape[1:], dtype=x.dtype)
        self._step_ins.append((x, inner))
        return inner

    def memory(self, init=None, shape=None, batch_ref=None, init_value=0.0,
               init_batch_dim_idx=0, ref_batch_dim_idx=1):
        self._assert_in_rnn_block_('memory')
        main = self.helper.main_program
        if init is None:
            if shape is None or batch_ref is None:
                raise ValueError("memory needs init or (shape, batch_ref)")
            # batch_ref is usually a per-step inner var; the boot op lives in
            # the parent block, so point it at the outer [T, B, ...] sequence
            # (whose batch axis is ref_batch_dim_idx=1, matching the
            # reference's default).
            for o, i in self._step_ins:
                if batch_ref is i:
                    batch_ref = o
                    break
            shape = list(shape)
            if not shape or shape[0] != -1:
                shape = [-1] + shape
            cur = main.current_block_idx
            main.current_block_idx = self._parent_idx
            try:
                init = tensor_mod.fill_constant_batch_size_like(
                    input=batch_ref, shape=shape,
                    dtype='float32', value=float(init_value),
                    input_dim_idx=ref_batch_dim_idx,
                    output_dim_idx=init_batch_dim_idx)
            finally:
                main.current_block_idx = cur
        pre = self._sub.create_var(
            name=unique_name.generate(self.helper.name + '.mem'),
            shape=init.shape, dtype=init.dtype)
        self._mems.append({'pre_var': pre, 'init_var': init, 'upd_var': None})
        return pre

    def update_memory(self, mem, x):
        self._assert_in_rnn_block_('update_memory')
        for m in self._mems:
            if m['pre_var'] is mem:
                m['upd_var'] = x
                return
        raise ValueError("update_memory: %r is not a memory of this RNN"
                         % mem.name)

    def step_output(self, o):
        self._assert_in_rnn_block_('step_output')
        T = self.seq_len if self.seq_len is not None else -1
        outer = self.helper.main_program.block(self._parent_idx).create_var(
            name=unique_name.generate(self.helper.name + '.out'),
            shape=(T,) + tuple(o.shape), dtype=o.dtype)
        self._outs.append((o, outer))

    def output(self, *outputs):
        for o in outputs:
            self.step_output(o)

    def _complete(self):
        if not self._step_ins:
            raise ValueError("StaticRNN needs at least one step_input")
        for m in self._mems:
            if m['upd_var'] is None:
                raise ValueError("memory %r never update_memory'd"
                                 % m['pre_var'].name)
        main = self.helper.main_program
        parent = main.block(self._parent_idx)
        inner_names = ({v.name for _, v in self._step_ins}
                       | {m['pre_var'].name for m in self._mems})
        reads = [v for v in _outer_read(self._sub)
                 if v.name not in inner_names]
        parent.append_op(
            type='static_rnn',
            inputs={'X': [o for o, _ in self._step_ins],
                    'Init': [m['init_var'] for m in self._mems],
                    'Extra': reads},
            outputs={'Out': [outer for _, outer in self._outs]},
            attrs={'sub_block': self._sub.idx,
                   'step_ins': [(o.name, i.name) for o, i in self._step_ins],
                   'mems': [{'pre': m['pre_var'].name,
                             'init': m['init_var'].name,
                             'upd': m['upd_var'].name} for m in self._mems],
                   'outs': [(i.name, o.name) for i, o in self._outs]},
            infer_shape=False)

    def __call__(self, *args, **kwargs):
        if self.status != StaticRNN.AFTER_RNN_BLOCK:
            raise ValueError("RNN output can only be retrieved after rnn.step()")
        outs = [outer for _, outer in self._outs]
        return outs[0] if len(outs) == 1 else outs


# ---------------------------------------------------------------------------
# DynamicRNN
# ---------------------------------------------------------------------------

class DynamicRNN(object):
    """reference layers/control_flow.py:1511.

    Steps over padded [batch, T, ...] sequences (lod_level=1 vars); memory
    updates are masked past each sequence's length, outputs keep the input's
    lod. The reference instead sorts sequences by length and shrinks the
    batch each step (DynamicRNNOp), a dynamic shape per step; here it is a
    fixed-T masked loop (the same numbers at the live positions).
    """

    BEFORE_RNN = 0
    IN_RNN = 1
    AFTER_RNN = 2

    def __init__(self, name=None):
        self.helper = LayerHelper('dynamic_rnn', name=name)
        self.status = DynamicRNN.BEFORE_RNN
        self._step_ins = []    # (outer, inner)
        self._static_ins = []  # (outer, inner)
        self._mems = []        # {'pre_var','init_var','value','shape','upd_var'}
        self._outs = []        # (inner, outer)
        self._sub = None
        self._parent_idx = None

    @contextlib.contextmanager
    def block(self):
        main = self.helper.main_program
        self._parent_idx = main.current_block_idx
        self._sub = main.create_block()
        self.status = DynamicRNN.IN_RNN
        try:
            yield
        finally:
            main.rollback()
            self.status = DynamicRNN.AFTER_RNN
        self._complete()

    def _assert_in_rnn_block_(self, method):
        if self.status != DynamicRNN.IN_RNN:
            raise ValueError("{0} can only be invoked inside rnn.block()"
                             .format(method))

    def step_input(self, x):
        self._assert_in_rnn_block_('step_input')
        if not x.lod_level:
            raise ValueError("DynamicRNN.step_input expects a lod_level>0 "
                             "sequence var; use StaticRNN for dense tensors")
        inner = self._sub.create_var(
            name=unique_name.generate(self.helper.name + '.step_in'),
            shape=(x.shape[0],) + tuple(x.shape[2:]), dtype=x.dtype)
        self._step_ins.append((x, inner))
        return inner

    def static_input(self, x):
        self._assert_in_rnn_block_('static_input')
        inner = self._sub.create_var(
            name=unique_name.generate(self.helper.name + '.static_in'),
            shape=x.shape, dtype=x.dtype, lod_level=x.lod_level)
        self._static_ins.append((x, inner))
        return inner

    def memory(self, init=None, shape=None, value=0.0, need_reorder=False,
               dtype='float32'):
        self._assert_in_rnn_block_('memory')
        if init is not None:
            mshape, mdtype = init.shape, init.dtype
        else:
            if shape is None:
                raise ValueError("memory needs init or shape")
            mshape, mdtype = (-1,) + tuple(shape), dtype
        pre = self._sub.create_var(
            name=unique_name.generate(self.helper.name + '.mem'),
            shape=mshape, dtype=mdtype)
        self._mems.append({'pre_var': pre, 'init_var': init,
                           'value': float(value), 'dtype': mdtype,
                           'shape': list(shape) if shape else None,
                           'upd_var': None})
        return pre

    def update_memory(self, ex_mem, new_mem):
        self._assert_in_rnn_block_('update_memory')
        for m in self._mems:
            if m['pre_var'] is ex_mem:
                m['upd_var'] = new_mem
                return
        raise ValueError("update_memory: %r is not a memory of this RNN"
                         % ex_mem.name)

    def output(self, *outputs):
        self._assert_in_rnn_block_('output')
        for o in outputs:
            T = self._step_ins[0][0].shape[1] if self._step_ins else -1
            outer = self.helper.main_program.block(self._parent_idx).create_var(
                name=unique_name.generate(self.helper.name + '.out'),
                shape=(o.shape[0], T) + tuple(o.shape[1:]), dtype=o.dtype,
                lod_level=1)
            self._outs.append((o, outer))

    def _complete(self):
        if not self._step_ins:
            raise ValueError("DynamicRNN needs at least one step_input")
        for m in self._mems:
            if m['upd_var'] is None:
                raise ValueError("memory %r never update_memory'd"
                                 % m['pre_var'].name)
        main = self.helper.main_program
        parent = main.block(self._parent_idx)
        inner_names = ({v.name for _, v in self._step_ins}
                       | {v.name for _, v in self._static_ins}
                       | {m['pre_var'].name for m in self._mems})
        reads = [v for v in _outer_read(self._sub)
                 if v.name not in inner_names]
        parent.append_op(
            type='dynamic_rnn',
            inputs={'X': [o for o, _ in self._step_ins],
                    'Static': [o for o, _ in self._static_ins],
                    'Init': [m['init_var'] for m in self._mems
                             if m['init_var'] is not None],
                    'Extra': reads},
            outputs={'Out': [outer for _, outer in self._outs]},
            attrs={'sub_block': self._sub.idx,
                   'step_ins': [(o.name, i.name) for o, i in self._step_ins],
                   'static_ins': [(o.name, i.name)
                                  for o, i in self._static_ins],
                   'mems': [{'pre': m['pre_var'].name,
                             'init': (m['init_var'].name
                                      if m['init_var'] is not None else None),
                             'value': m['value'], 'shape': m['shape'],
                             'dtype': m['dtype'],
                             'upd': m['upd_var'].name} for m in self._mems],
                   'outs': [(i.name, o.name) for i, o in self._outs]},
            infer_shape=False)

    def __call__(self, *args, **kwargs):
        if self.status != DynamicRNN.AFTER_RNN:
            raise ValueError("Output of DynamicRNN can only be retrieved "
                             "after rnn.block()")
        outs = [outer for _, outer in self._outs]
        return outs[0] if len(outs) == 1 else outs


def reorder_lod_tensor_by_rank(x, rank_table):
    """Identity: the padded-dense layout never shrinks the batch, so the
    reference's length-rank reordering (reorder_lod_tensor_by_rank_op.cc)
    has nothing to reorder."""
    return x


def ParallelDo(*args, **kwargs):
    raise NotImplementedError(
        "ParallelDo was deprecated in the reference; it has no counterpart "
        "in this package")
