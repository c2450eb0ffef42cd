"""Program / Block / Operator / Variable graph IR.

Parity: reference python/paddle/fluid/framework.py (Variable:142,
Operator:431, Block:855, Program:1339, Parameter:1874) and the JAX
package's fluid/framework.py, whose serialized form (`_to_dict`) this module
reproduces key for key, so a program saved by either package loads in the
other.

The Program is a Python-side op list. The Executor (executor.py) walks it
op by op, resolving each op type through the lowering registry
(ops_impl/). Shape inference runs at graph-build time through the SAME
rules evaluated on `meta` tensors (lowering.infer_op_shapes), so there is
exactly one definition of every op's semantics.
"""
import collections
import contextlib
import copy

from . import core
from . import unique_name

__all__ = [
    'Program', 'Operator', 'Parameter', 'Variable', 'Block',
    'default_startup_program', 'default_main_program', 'program_guard',
    'name_scope', 'get_var', 'grad_var_name', 'normalize_sharding',
]

GRAD_VAR_SUFFIX = "@GRAD"
# The reference's OpRole attr, used to prune backward/optimize ops in
# Program.clone(for_test=True).
ROLE_FORWARD = 0
ROLE_BACKWARD = 1
ROLE_OPTIMIZE = 2
ROLE_LRSCHED = 16
ROLE_METRIC = 32

# A distinctive stand-in for the dynamic batch dim (-1) during build-time
# shape inference; mapped back to -1 in inferred output shapes. A large
# prime so multiples of it can only have come from the stand-in itself and
# no plausible user tensor dim collides with it.
DYN_DIM = 999983


def grad_var_name(name):
    return name + GRAD_VAR_SUFFIX


def normalize_sharding(spec):
    """Normalize a sharding annotation into the canonical per-dim tuple (the
    JAX :49): each entry is a mesh-axis name, None (replicated dim) or a
    tuple of axis names; a bare string means dim 0 over that axis. Returns
    None for None. On a set_mesh program a persistable annotated on the
    data axis is held split over the ranks (ZeRO-3, fluid/mesh_step.py);
    the tier store's dim-sharding refusal reads it too."""
    if spec is None:
        return None
    if isinstance(spec, str):
        spec = (spec,)
    if not isinstance(spec, (list, tuple)):
        raise ValueError(
            'sharding must be a tuple of mesh-axis names / None / '
            'axis-name tuples, got %r' % (spec,))
    out = []
    for e in spec:
        if e is None:
            out.append(None)
        elif isinstance(e, str):
            out.append(e)
        elif (isinstance(e, (list, tuple)) and e
              and all(isinstance(a, str) for a in e)):
            out.append(tuple(e))
        else:
            raise ValueError(
                'bad sharding entry %r in %r: each dim is an axis name, '
                'None, or a non-empty tuple of axis names' % (e, spec))
    return tuple(out)


class Variable(object):
    """A named tensor in a Block. Reference framework.py:142.

    Holds static metadata only (shape may contain -1 for the batch dim);
    values live in a Scope as torch tensors at run time. `sharding` is the
    per-dim mesh-axis annotation (normalize_sharding): on a set_mesh
    program a persistable split over the data axis is held as each rank's
    block (ZeRO-3), and a tiered table refuses a sharded embedding dim
    from it (embedding.tiers). `tiered` marks a table that a tier
    store fronts (TieredVocabTable.validate_program stamps it). Both
    serialize only when set, as in the JAX package; other keys the port
    does not act on are accepted and dropped."""

    def __init__(self,
                 block,
                 name=None,
                 shape=None,
                 dtype='float32',
                 lod_level=0,
                 persistable=False,
                 stop_gradient=False,
                 is_data=False,
                 type=None,
                 sharding=None,
                 tiered=False,
                 **kwargs):
        self.block = block
        if name is None:
            name = unique_name.generate('_generated_var')
        self.name = name
        self.sharding = normalize_sharding(sharding)
        self.tiered = bool(tiered)
        self.shape = tuple(int(d) for d in shape) if shape is not None else None
        if self.shape is not None and DYN_DIM in self.shape:
            raise ValueError(
                "dim %d collides with the build-time dynamic-batch sentinel "
                "(framework.DYN_DIM); use a different size" % DYN_DIM)
        self.dtype = core.convert_dtype(dtype)
        self.lod_level = lod_level
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.is_data = is_data
        self.type = type or 'LOD_TENSOR'
        self.op = None  # producer op (set by append_op)
        if name not in block.vars:
            block.vars[name] = self

    def __repr__(self):
        return "Variable(name=%s, shape=%s, dtype=%s, lod=%d)" % (
            self.name, self.shape, self.dtype, self.lod_level)

    __str__ = __repr__

    @property
    def ndim(self):
        return len(self.shape)

    def astype(self, dtype):
        from .layers import tensor
        return tensor.cast(self, dtype)

    def _to_dict(self):
        d = dict(name=self.name,
                 shape=list(self.shape) if self.shape is not None else None,
                 dtype=self.dtype, lod_level=self.lod_level,
                 persistable=self.persistable,
                 stop_gradient=self.stop_gradient,
                 is_data=self.is_data, type=self.type,
                 cls=type(self).__name__)
        if self.sharding is not None:
            d['sharding'] = [list(e) if isinstance(e, tuple) else e
                             for e in self.sharding]
        if self.tiered:
            d['tiered'] = True
        return d


class Parameter(Variable):
    """A persistable, trainable Variable. Reference framework.py:1874."""

    def __init__(self, block, shape, dtype, **kwargs):
        kwargs['persistable'] = True
        self.trainable = kwargs.pop('trainable', True)
        self.optimize_attr = kwargs.pop('optimize_attr', {'learning_rate': 1.0})
        self.regularizer = kwargs.pop('regularizer', None)
        self.gradient_clip_attr = kwargs.pop('gradient_clip_attr', None)
        self.do_model_average = kwargs.pop('do_model_average', None)
        super(Parameter, self).__init__(block, shape=shape, dtype=dtype, **kwargs)

    def _to_dict(self):
        d = super(Parameter, self)._to_dict()
        d['trainable'] = self.trainable
        d['optimize_attr'] = self.optimize_attr
        return d


class Operator(object):
    """One op in a Block. Reference framework.py:431.

    inputs/outputs map slot name -> list of Variable. attrs are plain
    JSON-able python values. The op's semantics are defined solely by the
    lowering rule registered for `type` in ops_impl/. `callsite` is the
    build-site provenance a JAX-package artifact may carry; the port keeps
    it through clone/prune/save and records none of its own.
    """

    def __init__(self, block, type, inputs=None, outputs=None, attrs=None,
                 callsite=None):
        self.block = block
        self.type = type
        self.inputs = {}
        self.outputs = {}
        self.callsite = callsite
        self.attrs = dict(attrs or {})
        self.attrs.setdefault('op_role', ROLE_FORWARD)
        for slot, vs in (inputs or {}).items():
            if vs is None:
                continue
            self.inputs[slot] = list(vs) if isinstance(vs, (list, tuple)) \
                else [vs]
        for slot, vs in (outputs or {}).items():
            if vs is None:
                continue
            vs = list(vs) if isinstance(vs, (list, tuple)) else [vs]
            self.outputs[slot] = vs
            for v in vs:
                if isinstance(v, Variable):
                    v.op = self

    def input(self, slot):
        return [v.name for v in self.inputs.get(slot, [])]

    def output(self, slot):
        return [v.name for v in self.outputs.get(slot, [])]

    @property
    def input_arg_names(self):
        return [v.name for vs in self.inputs.values() for v in vs]

    @property
    def output_arg_names(self):
        return [v.name for vs in self.outputs.values() for v in vs]

    def attr(self, name):
        return self.attrs[name]

    def has_attr(self, name):
        return name in self.attrs

    def __repr__(self):
        ins = {k: [v.name for v in vs] for k, vs in self.inputs.items()}
        outs = {k: [v.name for v in vs] for k, vs in self.outputs.items()}
        return "{%s: %s -> %s %s}" % (self.type, ins, outs,
                                      {k: v for k, v in self.attrs.items()
                                       if k not in ('op_role',)})

    def _to_dict(self):
        d = dict(
            type=self.type,
            inputs={k: [v.name for v in vs] for k, vs in self.inputs.items()},
            outputs={k: [v.name for v in vs] for k, vs in self.outputs.items()},
            attrs={k: v for k, v in self.attrs.items()},
        )
        if self.callsite:
            d['callsite'] = self.callsite
        return d


class Block(object):
    """An ordered op list + var table. Reference framework.py:855."""

    def __init__(self, program, idx, parent_idx=-1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars = collections.OrderedDict()
        self.ops = []

    @property
    def parent_block(self):
        if self.parent_idx < 0:
            return None
        return self.program.block(self.parent_idx)

    def var(self, name):
        v = self.vars.get(name)
        if v is None:
            raise ValueError("Variable %r not found in block %d" % (name, self.idx))
        return v

    def _var_recursive(self, name):
        blk = self
        while blk is not None:
            if name in blk.vars:
                return blk.vars[name]
            blk = blk.parent_block
        raise ValueError("Variable %r not found (recursive)" % name)

    def has_var(self, name):
        return name in self.vars

    def all_parameters(self):
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    def create_var(self, *args, **kwargs):
        return Variable(self, *args, **kwargs)

    def create_parameter(self, *args, **kwargs):
        return Parameter(self, *args, **kwargs)

    def append_op(self, type=None, inputs=None, outputs=None, attrs=None,
                  infer_shape=True, callsite=None):
        op = Operator(self, type=type, inputs=inputs, outputs=outputs,
                      attrs=attrs, callsite=callsite)
        self.ops.append(op)
        self.program._bump_version()
        if infer_shape:
            from . import lowering
            if lowering.has_rule(op.type):
                lowering.infer_op_shapes(op)
        return op

    def _to_dict(self):
        return dict(idx=self.idx, parent_idx=self.parent_idx,
                    vars=[v._to_dict() for v in self.vars.values()],
                    ops=[op._to_dict() for op in self.ops])


class Program(object):
    """A list of Blocks; the unit the Executor runs. Reference
    framework.py:1339. `_version` counts mutations."""

    _next_uid = 0

    def __init__(self):
        self.blocks = [Block(self, 0)]
        self.current_block_idx = 0
        self.random_seed = 0
        self._version = 0
        # the mesh spec (set_mesh): ((axis, size), ...) in layout order and
        # the axis feeds split their batch over (the JAX :459-464)
        self._mesh_axes = None
        self._mesh_data_axis = None
        # ParallelExecutor's BuildStrategy.Reduce, for one call: ZeRO-3 of
        # every persistable the annotations leave whole (mesh_step)
        self._mesh_fsdp = False
        self._uid = Program._next_uid
        Program._next_uid += 1

    def set_mesh(self, axes, data_axis=None):
        """Declare the mesh this Program's sharding annotations refer to
        (the JAX :472-535): the program-level half of the annotation
        surface, whose per-tensor half is ``ParamAttr(sharding=...)`` /
        ``Variable.sharding``.

        axes: {'dp': 8}-style dict (insertion order is the layout, row
        major over the ranks) or an ``((name, size), ...)`` sequence;
        ``set_mesh(None)`` clears the spec. data_axis: the axis feed
        batches split their leading dim over; defaults to 'dp' (then
        'data') when present, else feeds replicate. ``data_axis=False``
        makes feeds replicate even when a 'dp'/'data' axis exists (the
        sharded serving posture) and survives clone and the
        _to_dict/_from_dict round trip.

        The Executor runs an annotated Program on every rank of the mesh
        (fluid/mesh_step.py); plain run/run_bundle/Trainer take that path.
        A non-data axis of size > 1 (tensor, sequence or pipeline
        parallelism) raises NotImplementedError when the program runs."""
        if axes is None:
            self._mesh_axes = None
            self._mesh_data_axis = None
            self._bump_version()
            return self
        items = tuple(axes.items()) if isinstance(axes, dict) \
            else tuple((str(n), int(s)) for n, s in axes)
        if not items:
            raise ValueError('set_mesh needs at least one (axis, size)')
        seen = set()
        for name, size in items:
            if not isinstance(name, str) or not name:
                raise ValueError('mesh axis name must be a non-empty '
                                 'string, got %r' % (name,))
            if name in seen:
                raise ValueError('duplicate mesh axis %r' % name)
            seen.add(name)
            if int(size) < 1:
                raise ValueError('mesh axis %r has size %r' % (name, size))
        items = tuple((n, int(s)) for n, s in items)
        if data_axis is None:
            for cand in ('dp', 'data'):
                if cand in seen:
                    data_axis = cand
                    break
        elif data_axis is not False and data_axis not in seen:
            raise ValueError('data_axis %r is not a mesh axis (have %r)'
                             % (data_axis, sorted(seen)))
        self._mesh_axes = items
        self._mesh_data_axis = data_axis
        self._bump_version()
        return self

    @property
    def mesh_axes(self):
        """The declared mesh spec as an ordered dict, or None."""
        if self._mesh_axes is None:
            return None
        return collections.OrderedDict(self._mesh_axes)

    def _bump_version(self):
        self._version += 1

    def global_block(self):
        return self.blocks[0]

    def current_block(self):
        return self.blocks[self.current_block_idx]

    def block(self, idx):
        return self.blocks[idx]

    def create_block(self, parent_idx=None):
        """Append a sub-block whose parent is the current block (or
        `parent_idx`) and make it current (the JAX :555): the body of a
        While, a branch of IfElse or Switch, an RNN's step."""
        new_idx = len(self.blocks)
        parent = self.current_block_idx if parent_idx is None else parent_idx
        self.blocks.append(Block(self, new_idx, parent))
        self.current_block_idx = new_idx
        return self.current_block()

    def rollback(self):
        """Make the current block's parent current again (the JAX
        :562)."""
        self.current_block_idx = self.blocks[self.current_block_idx].parent_idx

    @property
    def num_blocks(self):
        return len(self.blocks)

    def list_vars(self):
        for blk in self.blocks:
            for v in blk.vars.values():
                yield v

    def all_parameters(self):
        return self.global_block().all_parameters()

    def clone(self, for_test=False):
        """Deep-copy the program. With for_test=True, prune backward/optimize
        ops and flip is_test on dropout etc. (reference Program.clone +
        inference_optimize)."""
        p = Program()
        p.random_seed = self.random_seed
        # execution flags travel with the program, as in the JAX package's
        # clone (:583-588): amp mode (and the AMP pass's IR marker), the
        # Float16Transpiler's fetch contract, the quant mark and its IR
        # marker
        for flag in ('_amp', '_amp_ir', '_fetch_f32', '_quant', '_quant_ir',
                     '_quant_ops'):
            if hasattr(self, flag):
                setattr(p, flag, getattr(self, flag))
        # the mesh spec and a DistributeTranspiler's annotation travel with
        # the program (:590-598); per-var specs ride Variable._to_dict
        p._mesh_axes = self._mesh_axes
        p._mesh_data_axis = self._mesh_data_axis
        if getattr(self, '_dist_config', None) is not None:
            p._dist_config = dict(self._dist_config)
        p.blocks = []
        for blk in self.blocks:
            nb = Block(p, blk.idx, blk.parent_idx)
            p.blocks.append(nb)
            for v in blk.vars.values():
                d = v._to_dict()
                cls = d.pop('cls')
                d.pop('name')
                if cls == 'Parameter':
                    d.pop('trainable', None)
                    d.pop('optimize_attr', None)
                    Parameter(nb, name=v.name,
                              trainable=getattr(v, 'trainable', True),
                              optimize_attr=dict(v.optimize_attr),
                              regularizer=v.regularizer,
                              gradient_clip_attr=v.gradient_clip_attr,
                              do_model_average=v.do_model_average, **d)
                else:
                    Variable(nb, name=v.name, **d)
        for bi, blk in enumerate(self.blocks):
            nb = p.blocks[bi]
            # a sub-block op binds the var of its own block or of the
            # nearest ancestor that holds it (the JAX nested lookup,
            # :626-632)
            for op in blk.ops:
                role = op.attrs.get('op_role', ROLE_FORWARD)
                if for_test and role in (ROLE_BACKWARD, ROLE_OPTIMIZE,
                                         ROLE_LRSCHED):
                    continue
                ins = {k: [nb._var_recursive(v.name) for v in vs]
                       for k, vs in op.inputs.items()}
                outs = {k: [nb._var_recursive(v.name) for v in vs]
                        for k, vs in op.outputs.items()}
                attrs = copy.deepcopy(op.attrs)
                if for_test and 'is_test' in attrs:
                    attrs['is_test'] = True
                nb.append_op(type=op.type, inputs=ins, outputs=outs,
                             attrs=attrs, infer_shape=False,
                             callsite=op.callsite)
        p.current_block_idx = 0
        p._bump_version()
        return p

    def inference_optimize(self):
        return self.clone(for_test=True)

    def optimize(self, level='default', feeds=None, fetches=None):
        """Ahead-of-execution optimization (the JAX :697-720): a NEW
        Program rewritten by the fluid.passes pipeline (AMP cast
        insertion, quantization where marked, constant folding, and with
        `fetches` CSE and dead-op elimination). This program is never
        mutated; the PassReport lands on the result as `_opt_report`.
        Folding evaluates the rules on the CPU.

        The Executor applies the same pipeline behind
        PADDLE_TPU_OPT={off,default,aggressive}, once per step-artifact
        cache key; this method is the manual surface (e.g. before
        save_inference_model)."""
        from . import passes
        p, report = passes.optimize(self, feeds=feeds, fetches=fetches,
                                    level=level)
        if p is self:
            # passes.optimize returns the input itself at level 'off'; this
            # method promises a program the caller owns
            p = self.clone(for_test=False)
            p._opt_report = report
        return p

    def prune(self, targets):
        """Backward-slice the program to the ops needed to compute
        `targets` (reference Program.prune / C++ framework/prune.cc)."""
        if not isinstance(targets, (list, tuple)):
            targets = [targets]
        needed = {t.name if isinstance(t, Variable) else str(t)
                  for t in targets}
        p = self.clone(for_test=False)
        blk = p.global_block()
        keep = []
        for op in reversed(blk.ops):
            if set(op.output_arg_names) & needed:
                keep.append(op)
                needed |= set(op.input_arg_names)
        keep.reverse()
        blk.ops = keep
        p._bump_version()
        return p

    def to_string(self, throw_on_error=False, with_details=False):
        lines = []
        for blk in self.blocks:
            lines.append("-- block %d (parent %d) --" % (blk.idx, blk.parent_idx))
            for v in blk.vars.values():
                lines.append("    " + repr(v))
            for op in blk.ops:
                lines.append("  " + repr(op))
        return "\n".join(lines)

    __str__ = to_string
    __repr__ = to_string

    # -- serialization (reference: ProgramDesc protobuf round-trip) --
    def _to_dict(self):
        d = dict(random_seed=self.random_seed,
                 blocks=[b._to_dict() for b in self.blocks])
        if self._mesh_axes is not None:
            # the mesh spec survives save/load (the JAX :759-763)
            d['mesh'] = {'axes': [[n, s] for n, s in self._mesh_axes],
                         'data_axis': self._mesh_data_axis}
        return d

    @staticmethod
    def _from_dict(d):
        p = Program()
        p.random_seed = d.get('random_seed', 0)
        mesh = d.get('mesh')
        if mesh:
            p.set_mesh([(n, s) for n, s in mesh['axes']],
                       data_axis=mesh.get('data_axis'))
        p.blocks = []
        for bd in d['blocks']:
            blk = Block(p, bd['idx'], bd['parent_idx'])
            p.blocks.append(blk)
            for vd in bd['vars']:
                vd = dict(vd)
                cls = vd.pop('cls', 'Variable')
                name = vd.pop('name')
                if cls == 'Parameter':
                    vd.pop('optimize_attr', None)
                    Parameter(blk, name=name, **vd)
                else:
                    Variable(blk, name=name, **vd)
        for bd in d['blocks']:
            blk = p.blocks[bd['idx']]
            for od in bd['ops']:
                ins = {k: [blk._var_recursive(n) for n in vs]
                       for k, vs in od['inputs'].items()}
                outs = {k: [blk._var_recursive(n) for n in vs]
                        for k, vs in od['outputs'].items()}
                blk.append_op(type=od['type'], inputs=ins, outputs=outs,
                              attrs=od['attrs'], infer_shape=False,
                              callsite=od.get('callsite'))
        p._bump_version()
        return p


_main_program_ = Program()
_startup_program_ = Program()


def default_startup_program():
    return _startup_program_


def default_main_program():
    return _main_program_


def switch_main_program(program):
    global _main_program_
    prev = _main_program_
    _main_program_ = program
    return prev


def switch_startup_program(program):
    global _startup_program_
    prev = _startup_program_
    _startup_program_ = program
    return prev


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    prev_main = switch_main_program(main_program)
    prev_start = None
    if startup_program is not None:
        prev_start = switch_startup_program(startup_program)
    try:
        yield
    finally:
        switch_main_program(prev_main)
        if prev_start is not None:
            switch_startup_program(prev_start)


_name_scope_stack = []


@contextlib.contextmanager
def name_scope(prefix=None):
    """A named region of the program being built (the JAX :843-852): a
    stack of prefixes, pushed and popped; nothing reads it."""
    _name_scope_stack.append(prefix or '')
    try:
        yield
    finally:
        _name_scope_stack.pop()


def get_var(name, program=None):
    if program is None:
        program = default_main_program()
    return program.global_block()._var_recursive(name)
