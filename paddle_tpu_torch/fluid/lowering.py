"""Op lowering registry: Fluid op symbols -> PyTorch.

Parity: the JAX package's fluid/lowering.py (register/get_rule, Ctx,
run_op:253, run_block:273, build-time shape inference :490-586). Each op
type has ONE rule `(ins, attrs, ctx) -> {slot: tensor}` on torch tensors.
The Executor walks a Program eagerly through these rules on its device;
build-time shape inference evaluates the same rules on `meta` tensors
(shapes and dtypes only, no storage), with the dynamic batch dim stood in
by framework.DYN_DIM, so op semantics are defined exactly once.

SeqValue (lowering.py:125-186) is the runtime value of a lod_level > 0
variable: padded data [batch, time, ...] with its lengths. SparseRows
(:189-231) carries the touched-rows gradient of an is_sparse embedding
table. ArrayValue (:292-475) is the value of a LOD_TENSOR_ARRAY: a
fixed-capacity buffer and a live length on the device.

Block ops (while, ifelse, switch, static_rnn, dynamic_rnn:
ops_impl/block_ops.py) register through register_block_op (:43-56); their
rules receive (op, env, ctx), run their sub-blocks themselves through
run_block and bind their outputs in env.
"""
import torch

from . import core
from .framework import DYN_DIM

_RULES = {}
_BLOCK_RULES = {}
_CONSTANT_OPS = set()
_BEST_EFFORT_SHAPES = set()


class NoRuleError(KeyError):
    pass


def register(op_type, constant=False, best_effort_shapes=False):
    """Register the rule for op_type. constant=True declares that the
    rule's outputs depend on its attrs alone (no inputs, no randomness):
    run_op then evaluates it once per op and device and reuses the result,
    the eager counterpart of XLA folding the constant into the compiled
    step — except where the op writes a persistable (a startup
    initializer): the scope owns that tensor, and the sparse optimizer
    rules update tables and moments in place, so each run hands out a
    fresh copy of the cached result (a device-side copy, which a captured
    CUDA graph can replay).

    best_effort_shapes=True: build-time shape inference of the op may
    fail, and then leaves the declared shapes alone, as the JAX package's
    inference does for every op (lowering.py:537-557). The rule's inputs
    at build time lack what only a run has (a beam step sees the LoD
    decoder's 2-level values without their outer levels; a reshape by a
    fixed dim that does not divide the dynamic dim's stand-in DYN_DIM),
    and the JAX program's var shapes are what that failure leaves them."""
    def deco(fn):
        _RULES[op_type] = fn
        if constant:
            _CONSTANT_OPS.add(op_type)
        if best_effort_shapes:
            _BEST_EFFORT_SHAPES.add(op_type)
        return fn
    return deco


def register_block_op(op_type):
    """Register a structured-control-flow rule (the JAX :43-56): unlike a
    plain rule (ins, attrs, ctx) -> outs, a block rule receives (op, env,
    ctx), runs its sub-block(s) through run_block and binds its outputs
    in env (the reference's WhileOp / ConditionalBlockOp / RecurrentOp
    sub-scope interpreters, paddle/fluid/operators/while_op.cc,
    conditional_block_op.cc, recurrent_op.cc)."""
    def deco(fn):
        _BLOCK_RULES[op_type] = fn
        return fn
    return deco


def get_rule(op_type):
    try:
        return _RULES[op_type]
    except KeyError:
        raise NoRuleError("no lowering rule for op %r" % op_type)


def has_rule(op_type):
    return op_type in _RULES


class Ctx(object):
    """Per-run lowering context: run mode, AMP (the JAX Ctx's `amp`,
    lowering.py:81-96), the torch.device every tensor of the run lives on,
    and the Executor's torch.Generator that random ops draw from (None
    under shape inference).

    The control-flow rules (ops_impl/block_ops.py) add three fields:
    `pred`, the device-side bool of the enclosing while iterations (None
    outside a loop): an array write inside a loop body takes effect only
    where it is true; `loops`, a list the step artifact hands in, to which
    every `while` appends (op label, bound, still-running flag) for the
    host to read after the step; `inplace`, False inside an IfElse or
    Switch branch (whose array writes must not touch the buffer the other
    branch reads) and an RNN step (whose writes to an outer array stay in
    the step, as in JAX).

    `mesh` is the parallel.Mesh a rule runs under when its token input
    holds this rank's rows of a dp-sharded batch (fluid/mesh_step.py hands
    it to moe_mlp, as the JAX Ctx carries the step's mesh), else None."""

    __slots__ = ('is_test', 'amp', 'device', 'generator', 'pred', 'loops',
                 'inplace', 'mesh')

    def __init__(self, device, generator=None, is_test=False, amp=False,
                 pred=None, loops=None, inplace=True, mesh=None):
        self.device = device
        self.generator = generator
        self.is_test = is_test
        self.amp = amp
        self.pred = pred
        self.loops = loops
        self.inplace = inplace
        self.mesh = mesh

    def derive(self, **fields):
        """A copy of this context with `fields` replaced."""
        kw = {k: getattr(self, k) for k in self.__slots__}
        kw.update(fields)
        return Ctx(**kw)


def amp_cast(ctx, *xs):
    """Under AMP, cast fp32 matmul / conv / attention operands to bf16 for
    the tensor cores (the JAX :98-104); anything else passes through."""
    if not ctx.amp:
        return xs if len(xs) > 1 else xs[0]
    out = tuple(x.to(torch.bfloat16) if x.dtype == torch.float32 else x
                for x in xs)
    return out if len(out) > 1 else out[0]


class SparseRows(object):
    """Sparse gradient of an embedding table: the rows actually touched
    (the reference's SelectedRows, paddle/fluid/framework/selected_rows.h).

    `ids` int64 [N] are the looked-up row indices (duplicates allowed, in
    lookup order), `rows` [N, D] the per-occurrence gradients; the dense
    gradient they stand for is index_add(zeros(dense_shape), ids, rows).
    The optimizer rules (ops_impl/optim_ops.py) consume it with row
    updates, so the vocab-sized dense @GRAD buffer never exists."""

    __slots__ = ('ids', 'rows', 'dense_shape')

    def __init__(self, ids, rows, dense_shape):
        self.ids = ids
        self.rows = rows
        self.dense_shape = tuple(dense_shape)

    @property
    def dtype(self):
        return self.rows.dtype

    def astype(self, dtype):
        return SparseRows(self.ids, self.rows.to(dtype), self.dense_shape)

    def to_dense(self):
        out = torch.zeros(self.dense_shape, dtype=self.rows.dtype,
                          device=self.rows.device)
        return out.index_add_(0, self.ids, self.rows)


class SeqValue(object):
    """Runtime value of a lod_level > 0 Variable: dense padded data plus
    lengths (the JAX :125-186).

    The reference's LoDTensor stores sequences flattened [total_tokens, d]
    with an offset table (paddle/fluid/framework/lod_tensor.h); here
    `data` is [batch, max_len, ...], so every rule is a masked dense op and
    a captured graph sees static shapes. `lengths` int64 [batch] is the
    innermost level's lengths in rows (the JAX package's are int32; the
    values agree, and int64 is torch's index dtype). Every level above
    the innermost rides in `outer_lengths`, a tuple of int64 vectors,
    outermost first: level k's entries count level k+1's sequences.
    `beam_cap` marks the capacity form of the LoD beam decoder (JAX
    ops_impl/lod_beam.py); no rule of the port makes one yet."""

    __slots__ = ('data', 'lengths', 'outer_lengths', 'beam_cap')

    def __init__(self, data, lengths, outer_lengths=None, beam_cap=False):
        self.data = data
        self.lengths = lengths
        if outer_lengths is not None and not isinstance(outer_lengths,
                                                        tuple):
            outer_lengths = tuple(outer_lengths) \
                if isinstance(outer_lengths, list) else (outer_lengths,)
        self.outer_lengths = outer_lengths or None
        self.beam_cap = bool(beam_cap)

    def mask(self, dtype=torch.float32):
        """[batch, max_len] validity mask, on the data's device."""
        steps = torch.arange(self.data.shape[1], device=self.lengths.device)
        return (steps[None, :] < self.lengths[:, None]).to(dtype)

    def with_leaves(self, leaves):
        """A SeqValue of this one's structure over `leaves` (as leaves_of
        orders them)."""
        leaves = tuple(leaves)
        return SeqValue(leaves[0], leaves[1], leaves[2:] or None,
                        beam_cap=self.beam_cap)


def data_of(v):
    return v.data if isinstance(v, SeqValue) else v


def like(template, new_data):
    """Wrap new_data with template's sequence structure (if any)."""
    if isinstance(template, SeqValue):
        return SeqValue(new_data, template.lengths, template.outer_lengths,
                        beam_cap=template.beam_cap)
    return new_data


def first_seq(*vals):
    for v in vals:
        if isinstance(v, SeqValue):
            return v
    return None


def leaves_of(v):
    """The tensors of a value: a SeqValue's (data, lengths,
    *outer_lengths), or (v,)."""
    if isinstance(v, SeqValue):
        return (v.data, v.lengths) + tuple(v.outer_lengths or ())
    return (v,)


def map_value(fn, v):
    """fn over every tensor of v (a SeqValue's leaves, or v itself)."""
    if isinstance(v, SeqValue):
        return v.with_leaves(fn(t) for t in leaves_of(v))
    return fn(v)


# Default slot count of a LoDTensorArray (the JAX :289). The layers read
# layers/control_flow.py:ARRAY_CAPACITY (initialized from this) when they
# build; this is the fallback of an op without a capacity attr, and the
# bound of a while that carries no array.
DEFAULT_ARRAY_CAPACITY = 128


def _slot_index(i, cap):
    """The slot index as a [1] int64 tensor clamped to [0, cap - 1] on the
    device, as lax.dynamic_index_in_dim and dynamic_update_index_in_dim
    clamp (no host read)."""
    return torch.clamp(i.reshape(1).long(), 0, cap - 1)


class ArrayValue(object):
    """Runtime value of a LOD_TENSOR_ARRAY variable (the JAX :292-475).

    The reference's LoDTensorArray is a C++ vector<LoDTensor> that
    array_write grows inside While loops (operators/array_write_op.cc). A
    captured graph needs static shapes, so an array is a preallocated
    buffer of `capacity` slots [capacity, *elem] plus a live-length
    scalar (int64, on the device); reads and writes index one slot with a
    device index, clamped to the capacity.

    Elements may be LoD-carrying SeqValues (the book's beam-search decoder
    stores 2-level selected ids and scores in arrays): `buffer` is then a
    TUPLE of stacked leaf buffers (data, lengths, *outer_lengths) and
    `n_outer` says how many trailing buffers are outer LoD levels; -1
    marks a plain dense element. `beam` records that the stored elements
    are capacity-form beam values, so array_read rebuilds them with the
    flag set.

    A write touches one slot. It writes the buffer in place where no
    gradient flows through the array (an inference step, a decoder), and
    out of place under autograd (a write into a tensor autograd has saved
    would break its backward). Inside a while body the write takes effect
    only where the iteration is live (`pred`), which is what lets the
    loop predicate its arrays without a select over every buffer."""

    __slots__ = ('buffer', 'length', 'n_outer', 'beam')

    def __init__(self, buffer, length, n_outer=-1, beam=False):
        self.buffer = buffer
        self.length = length
        self.n_outer = n_outer
        self.beam = bool(beam)

    @property
    def is_seq(self):
        return self.n_outer >= 0

    @property
    def leaves(self):
        """The buffer tensors, in the order of a SeqValue's leaves."""
        return tuple(self.buffer) if self.is_seq else (self.buffer,)

    @property
    def capacity(self):
        return self.leaves[0].shape[0]

    def with_leaves(self, leaves, length, beam=None):
        """An array of this one's structure over `leaves` (as `leaves`
        orders them) and `length`."""
        leaves = tuple(leaves)
        return ArrayValue(leaves if self.is_seq else leaves[0], length,
                          self.n_outer,
                          beam=self.beam if beam is None else beam)

    def read(self, i):
        """Element at slot i (a device index; the SeqValue rebuilt for a
        LoD array). Each leaf is a copy of its slot, never a view."""
        idx = _slot_index(i, self.capacity)
        leaves = tuple(b.index_select(0, idx)[0] for b in self.leaves)
        if not self.is_seq:
            return leaves[0]
        outer = leaves[2:2 + self.n_outer] if self.n_outer else None
        return SeqValue(leaves[0], leaves[1], outer, beam_cap=self.beam)

    @staticmethod
    def _grow_rows(buf, rows_new, n_sources=None):
        """[cap, r_old, ...] -> [cap, rows_new, ...]: row i moves to
        i * stride (the LoD beam capacity convention: each source's rows
        land at the start of its capacity block; ops_impl/lod_beam.py).
        That placement is right only when every source owns exactly one
        narrow row (r_old == number of sources), so where the caller
        knows the source count, widening anything else raises."""
        r_old = buf.shape[1]
        if rows_new == r_old:
            return buf
        if rows_new % r_old:
            raise ValueError(
                'array_write: element rows grew %d -> %d; capacity '
                'widening needs an integer stride' % (r_old, rows_new))
        if n_sources is not None and r_old != n_sources:
            raise ValueError(
                'array_write: cannot widen %d rows to capacity %d for %d '
                'sources: stride placement is only valid from one row '
                'per source (%d rows); compact the init to one row per '
                'source before the loop' % (r_old, rows_new, n_sources,
                                            n_sources))
        out = buf.new_zeros((buf.shape[0], rows_new) + tuple(buf.shape[2:]))
        out[:, ::rows_new // r_old] = buf
        return out

    def _grown_to(self, x):
        """Widen or convert the buffers so a write of `x` fits (the book's
        decode idiom writes one row per source before the While,
        beam_size rows per source inside it). Widening follows the beam
        capacity convention, so the result is beam-flagged; the source
        count from x's outer LoD gates _grow_rows' one-row-per-source
        check."""
        if isinstance(x, SeqValue):
            n_outer = len(x.outer_lengths or ())
            n_src = (x.outer_lengths[0].shape[0]
                     if x.outer_lengths else None)
            if not self.is_seq:
                data = self._grow_rows(self.buffer, x.data.shape[0],
                                       n_sources=n_src)
                stride = x.data.shape[0] // self.buffer.shape[1]
                lens = torch.zeros((data.shape[0], x.data.shape[0]),
                                   dtype=x.lengths.dtype, device=data.device)
                lens[:, ::stride] = 1
                outer = tuple(
                    torch.ones((data.shape[0],) + tuple(o.shape),
                               dtype=o.dtype, device=data.device)
                    for o in (x.outer_lengths or ()))
                return ArrayValue((data, lens) + outer, self.length,
                                  n_outer, beam=True)
            d0 = self.buffer[0]
            if d0.ndim == x.data.ndim + 2 and d0.shape[2] == 1:
                # padded 2-level feed slots [B, max_len=1, ...] -> flat rows
                d0 = d0.reshape(tuple(d0.shape[:2]) + tuple(d0.shape[3:]))
            data = self._grow_rows(d0, x.data.shape[0], n_sources=n_src)
            lens = self._grow_rows(self.buffer[1], x.lengths.shape[0],
                                   n_sources=n_src)
            return ArrayValue((data, lens) + tuple(self.buffer[2:]),
                              self.length, self.n_outer,
                              beam=self.beam or data is not d0)
        if not self.is_seq:
            return ArrayValue(self._grow_rows(self.buffer,
                                              data_of(x).shape[0]),
                              self.length, -1, beam=self.beam)
        return self

    def _elem_fits(self, x):
        if isinstance(x, SeqValue):
            return (self.is_seq
                    and self.n_outer == len(x.outer_lengths or ())
                    and tuple(self.buffer[0].shape[1:])
                    == tuple(x.data.shape)
                    and tuple(self.buffer[1].shape[1:])
                    == tuple(x.lengths.shape))
        return (not self.is_seq
                and tuple(self.buffer.shape[1:]) == tuple(data_of(x).shape))

    def write(self, i, x, pred=None, inplace=True):
        """This array with slot i <- x (the buffers grow, by the capacity
        convention, when x is wider than the slots). `pred`: a device
        bool; where it is false the slot and the length keep their values.
        `inplace`: the caller lets the buffers be written in place; a
        write that a gradient flows through is out of place all the
        same."""
        if not isinstance(x, SeqValue) and self.is_seq:
            # a dense write into an LoD array (the encoder state fed to the
            # decode idiom's state array): one full-length group a row
            d = data_of(x)
            x = SeqValue(d, torch.ones((d.shape[0],), dtype=torch.int64,
                                       device=d.device),
                         tuple(torch.ones(tuple(b.shape[1:]), dtype=b.dtype,
                                          device=b.device)
                               for b in self.buffer[2:2 + self.n_outer])
                         or None, beam_cap=self.beam)
        if isinstance(x, SeqValue) and not self._elem_fits(x):
            slot = self.buffer[0] if self.is_seq else self.buffer
            if (x.data.ndim == slot.ndim and x.data.shape[1] == 1
                    and tuple(slot.shape[1:]) != tuple(x.data.shape)):
                # [rows, max_len=1, ...] padded element against flat-row
                # slots (the decode idiom's pre-loop feeds): drop the
                # singleton time dim before fitting or growing
                x = SeqValue(x.data[:, 0], x.lengths, x.outer_lengths,
                             beam_cap=x.beam_cap)
        if not self._elem_fits(x):
            grown = self._grown_to(x)
            if not grown._elem_fits(x):
                def shp(v):
                    if isinstance(v, SeqValue):
                        return ('seq', tuple(v.data.shape),
                                tuple(v.lengths.shape),
                                tuple(tuple(o.shape)
                                      for o in (v.outer_lengths or ())))
                    return tuple(getattr(v, 'shape', ()))
                raise TypeError(
                    'array_write: element %r does not fit (and cannot '
                    'grow to fit) array slots %r'
                    % (shp(x), [tuple(b.shape) for b in grown.leaves]))
            return grown.write(i, x, pred, inplace)
        cap = self.capacity
        idx = _slot_index(i, cap)
        vals = leaves_of(x) if isinstance(x, SeqValue) else (data_of(x),)
        grad = torch.is_grad_enabled() and any(
            t.requires_grad for t in self.leaves + tuple(vals))
        out = []
        for b, v in zip(self.leaves, vals):
            v = v.to(b.dtype).unsqueeze(0)
            if pred is not None:
                v = torch.where(pred, v, b.index_select(0, idx))
            if inplace and not grad:
                out.append(b.index_copy_(0, idx, v))
            else:
                out.append(b.index_copy(0, idx, v))
        length = torch.clamp(
            torch.maximum(self.length, i.reshape(()).long() + 1), max=cap)
        if pred is not None:
            length = torch.where(pred, length, self.length)
        return self.with_leaves(out, length,
                                beam=self.beam or getattr(x, 'beam_cap',
                                                          False))

    @classmethod
    def fresh(cls, x, capacity):
        """An empty array sized for elements shaped like x."""
        leaves = leaves_of(x) if isinstance(x, SeqValue) else (data_of(x),)
        bufs = tuple(t.new_zeros((capacity,) + tuple(t.shape))
                     for t in leaves)
        length = torch.zeros((), dtype=torch.int64, device=leaves[0].device)
        if isinstance(x, SeqValue):
            return cls(bufs, length, len(x.outer_lengths or ()),
                       beam=x.beam_cap)
        return cls(bufs[0], length, -1)


def run_op(op, env, ctx):
    """Resolve an op's inputs from env, apply its rule, bind outputs; a
    block op's rule binds its own (the JAX :263-265)."""
    if op.type in _BLOCK_RULES:
        _BLOCK_RULES[op.type](op, env, ctx)
        return
    if op.type in _CONSTANT_OPS:
        cache = op.__dict__.setdefault('_constant_outs', {})
        outs = cache.get(ctx.device)
        if outs is None:
            outs = cache[ctx.device] = get_rule(op.type)({}, op.attrs, ctx)
        if _writes_persistable(op):
            outs = {slot: [v.clone() for v in vals]
                    if isinstance(vals, (list, tuple)) else vals.clone()
                    for slot, vals in outs.items()}
    else:
        ins = {slot: [env[v.name] for v in vs]
               for slot, vs in op.inputs.items()}
        outs = get_rule(op.type)(ins, op.attrs, ctx)
    _bind_outputs(op, outs, env)


def _writes_persistable(op):
    return any(v.persistable for vs in op.outputs.values() for v in vs)


def run_block(block, env, ctx):
    """Execute every op of a block against env, in place."""
    for op in block.ops:
        run_op(op, env, ctx)


def _bind_outputs(op, outs, env):
    for slot, vs in op.outputs.items():
        vals = outs.get(slot)
        if vals is None:
            continue
        if not isinstance(vals, (list, tuple)):
            vals = [vals]
        for var, val in zip(vs, vals):
            if val is not None:
                env[var.name] = val


def spec_of(var):
    """Build-time abstract value of a Variable: a meta tensor of its shape
    (the dynamic dims stood in by DYN_DIM) and dtype, a SeqValue of meta
    tensors for a lod_level > 0 var (the JAX :490-506), or None when the
    shape is undeclared."""
    if var.shape is None:
        return None
    shape = tuple(DYN_DIM if d == -1 else d for d in var.shape)
    s = torch.empty(shape, dtype=core.torch_dtype(var.dtype), device='meta')
    if var.lod_level and var.lod_level > 0:
        # padded layout [batch, time, ...]: the shape carries both dynamic
        # dims (layers/io.py:data)
        lens = torch.empty((shape[0],), dtype=torch.int64, device='meta')
        if var.lod_level > 1:
            return SeqValue(s, lens, lens)
        return SeqValue(s, lens)
    return s


def shape_from_spec(t):
    """Declared-shape view of an inferred tensor: DYN_DIM is prime, so any
    multiple of it can only have come from the dynamic batch dim (merged
    by a reshape) and maps back to -1."""
    return tuple(-1 if d % DYN_DIM == 0 and d > 0 else int(d)
                 for d in t.shape)


def abstract_eval(op, in_specs):
    """Evaluate op's rule on abstract inputs ({slot: [meta tensor or
    SeqValue of meta tensors, ...]}, as spec_of makes them): the JAX
    :509-531. Returns the rule's outputs, meta tensors for tensors. A
    sequence input enters without its outer levels, as the JAX
    abstract_eval re-wraps it, so the declared shapes of a program are the
    JAX package's. Raises whatever the rule raises."""
    ins = {slot: [SeqValue(s.data, s.lengths) if isinstance(s, SeqValue)
                  else s for s in vs] for slot, vs in in_specs.items()}
    ctx = Ctx(torch.device('meta'),
              is_test=bool(op.attrs.get('is_test', False)))
    return get_rule(op.type)(ins, op.attrs, ctx)


def infer_op_shapes(op):
    """Build-time shape/dtype inference by evaluating the rule on meta
    tensors; replaces the reference's per-op C++ InferShape functions.
    An op with an undeclared input shape keeps its declared output shapes,
    as in the JAX package; a rule that raises on declared shapes is a bug
    and propagates, unless it was registered best_effort_shapes."""
    ins = {slot: [spec_of(v) for v in vs] for slot, vs in op.inputs.items()}
    if any(s is None for vs in ins.values() for s in vs):
        return
    if op.type in _BEST_EFFORT_SHAPES:
        try:
            outs = abstract_eval(op, ins)
        except Exception:   # noqa: BLE001 - the declared shapes stay
            return
    else:
        outs = abstract_eval(op, ins)
    for slot, vs in op.outputs.items():
        vals = outs.get(slot)
        if vals is None:
            continue
        if not isinstance(vals, (list, tuple)):
            vals = [vals]
        for var, val in zip(vs, vals):
            if val is None:
                continue
            spec = data_of(val)
            var.shape = shape_from_spec(spec)
            var.dtype = core.convert_dtype(spec.dtype)
            if isinstance(val, SeqValue) and var.lod_level == 0:
                var.lod_level = 1
