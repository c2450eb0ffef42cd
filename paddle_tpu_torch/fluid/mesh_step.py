"""The mesh half of the step: a Program run on every rank of a dp mesh
computes what the single-device step computes on the whole batch.

Parity: the JAX package runs ONE GSPMD program over the mesh
(executor.py:717-1050, step_artifact.py:79-121, 188-255, 342-384): every
reduction over the sharded batch axis is global there, because XLA inserts
the collectives. The port runs one copy of the program per rank, each on
its own rows, and inserts them itself:

  * The feed is the global batch; each rank takes its rows (a LoDTensor its
    rows and lengths, padded to the global batch's time bucket), unless
    parallel.global_batch marked the value as the rank's rows already.
  * `MeshPlan` marks which vars carry the dp-sharded batch axis,
    propagating from the feeds through the ops. An op that mixes rows
    across the batch completes its computation across the ranks: `mean`
    and a `reduce_sum`/`reduce_mean` over the batch all_reduce their local
    result; `batch_norm` in training normalizes with the global batch's
    mean and variance; `moe_mlp` runs its mesh path (parallel.moe). Only
    the ops known to be row-wise (`_ROW_WISE`, away from the batch axis)
    run on the rank's rows and keep their outputs sharded; every other op
    (metrics, norms of a whole tensor, reductions by max, axis-0 reshapes
    and concatenations, an op type the list lacks, ...) gathers its
    sharded inputs and computes on the global rows, so its outputs are
    replicated.
  * The gradient is seeded with 1 on every rank; the collectives' backward
    rules (parallel/_comm.py) keep a replicated value's cotangent true and
    a sharded value's N times true, so the parameters' gradients AVERAGED
    over the ranks are the global gradient, token-weighted losses and
    batch statistics included. The replicated parameters' gradients are
    averaged in buckets of at most 25 MiB, one all_reduce each.
  * ZeRO (`placement`): a persistable may be held as this rank's block of
    one dim. Optimizer accumulators (ZeRO-1/2: DistributeTranspiler's
    slice_var_up, parallel.shard_optimizer_states' rule) take a local
    update: the gradient of a parameter whose only reader is its optimizer
    op is reduce-scattered instead of all-reduced, every other full-size
    operand of the update is cut to the block, and the updated parameter is
    all-gathered. Parameters held so (ZeRO-3: BuildStrategy.Reduce,
    shard_parameters, a ParamAttr sharding on the data axis) are gathered
    at the start of the forward, their gradient reduce-scattered by the
    gather's backward, and updated in place as blocks.
  * Batch-sharded fetches are all-gathered along axis 0, so every rank
    returns the JAX step's fetches.

Everything runs on the current stream inside the step, so on the card the
collectives are captured into the step's CUDA graph with the rest of it.
Sparse tables keep their dense, all-reduced gradient under a mesh, as a
replicated is_sparse table does in the JAX package (step_artifact.py
:357-384). Random ops draw per rank (the executor offsets the seed by the
rank), where JAX draws one mask over the global batch.
"""
import collections
import json
import warnings

import numpy as np
import torch

from .. import parallel
from ..parallel import _comm
from .lowering import SeqValue, data_of, run_op

__all__ = ['MeshSpec', 'MeshPlan', 'mesh_spec', 'shard_feed', 'full_state']

_PARALLEL = 'ROADMAP.md Queue A, "Parallel"'
# the bucket of replicated gradients one all_reduce averages (DDP's default)
_BUCKET_BYTES = 25 << 20


def _not_ported(what):
    raise NotImplementedError('%s waits for the rest of the port\'s '
                              'parallelism (%s)' % (what, _PARALLEL))


class MeshSpec(object):
    """The mesh a program runs on and how its persistables are held:
    `placement` {name: dim} lists those held as this rank's block of dim
    `dim` (ZeRO: from the program's annotations, or from a
    DistributeTranspiler's, `source`), with their full shapes in
    `full_shapes`."""

    def __init__(self, program, mesh, data_axis, source):
        self.mesh = mesh
        self.data_axis = data_axis
        # the axis of size > 1, when a dp-only mesh has one under another
        # name or feeds replicate
        self.axis = next(iter(mesh.shape)) if data_axis in (None, False) \
            else data_axis
        self.n = mesh.shape[self.axis]
        self.rank = mesh.coords[self.axis]
        self.group = mesh.group(self.axis)
        self.placement = _placement(program, mesh.shape, source, self.n)
        self.full_shapes = {v.name: tuple(v.shape)
                            for v in program.list_vars()
                            if v.name in self.placement}

    def key(self):
        return (tuple(self.mesh.shape.items()), self.rank, self.data_axis,
                tuple(sorted(self.placement.items())))

    def block(self, t, dim):
        """This rank's block of t along dim."""
        b = t.shape[dim] // self.n
        return t.narrow(dim, self.rank * b, b)


def _accumulators(program):
    """The optimizer accumulators of a program: the persistable inputs of
    its update ops (those reading a Param and a Grad) other than the
    parameter, its gradient and the learning rate."""
    acc = {v.name for v in program.list_vars()
           if getattr(v, '_is_optimizer_accumulator', False)}
    for op in program.global_block().ops:
        if 'Param' in op.inputs and 'Grad' in op.inputs:
            for slot, vs in op.inputs.items():
                if slot not in ('Param', 'Grad', 'LearningRate'):
                    acc.update(v.name for v in vs if v.persistable)
    return acc


def _static_shape(v):
    if v.shape is None or any(d < 0 for d in v.shape):
        return None
    return tuple(v.shape)


def _placement(program, axes, source, n):
    """{name: dim} of the persistables held split over the ranks."""
    out = {}
    pvars = [v for v in program.list_vars() if v.persistable]
    if source == 'annotations':
        for v in pvars:
            if not v.sharding:
                continue
            shape = _static_shape(v)
            dims = []
            for d, e in enumerate(v.sharding):
                names = e if isinstance(e, tuple) else (e,)
                live = [a for a in names if a is not None
                        and axes.get(a, 1) > 1]
                unknown = [a for a in names if a is not None
                           and a not in axes]
                if unknown:
                    warnings.warn(
                        'sharding annotation %r on %r names an axis the '
                        'mesh %r lacks; replicating instead'
                        % (v.sharding, v.name, dict(axes)))
                    dims = []
                    break
                if live:
                    dims.append(d)
            if len(dims) > 1:
                _not_ported('splitting %r over more than one dim' % v.name)
            if dims and (shape is None or shape[dims[0]] % n):
                warnings.warn(
                    'sharding annotation %r on %r does not fit the mesh %r '
                    '(dim %d of %r); replicating instead'
                    % (v.sharding, v.name, dict(axes), dims[0], shape))
                continue
            if dims:
                out[v.name] = dims[0]
        if program._mesh_fsdp:
            # BuildStrategy.Reduce: ZeRO-3 of what the annotations leave
            # whole
            for v in pvars:
                shape = _static_shape(v)
                if v.sharding or shape is None:
                    continue
                d = parallel.fsdp_dim(shape, n)
                if d is not None:
                    out[v.name] = d
        return out
    dist = program._dist_config
    fsdp = bool(dist.get('shard_parameters', False))
    # ZeRO-3 subsumes the lower levels (the JAX executor.py:825-828)
    zero = bool(dist.get('shard_optimizer_states', False)) or fsdp
    acc = _accumulators(program)
    for v in pvars:
        shape = _static_shape(v)
        if shape is None:
            continue
        if v.name in acc:
            if zero and shape and shape[0] % n == 0:
                out[v.name] = 0
        elif fsdp:
            d = parallel.fsdp_dim(shape, n)
            if d is not None:
                out[v.name] = d
    return out


def mesh_spec(program):
    """The MeshSpec `program` runs on, or None for the single-device step.

    The mesh comes from a DistributeTranspiler's annotation, whose dp size
    is capped at the world, as the JAX executor caps it at the devices
    present (:800-806), else from Program.set_mesh (or ParallelExecutor,
    which sets it for a call), in the JAX executor's order. A one-rank
    mesh without a process group is the single-device step; with one, its
    collectives run. A non-data axis of size > 1 raises
    NotImplementedError. Cached on the program."""
    axes_attr = getattr(program, '_mesh_axes', None)
    dist_cfg = getattr(program, '_dist_config', None)
    if not axes_attr and dist_cfg is None:
        return None
    world = parallel.process_count()
    key = (program._version, axes_attr, program._mesh_data_axis,
           program._mesh_fsdp,
           json.dumps(dist_cfg, sort_keys=True, default=str), world,
           parallel.process_index(), parallel._world(),
           tuple((v.name, v.sharding) for v in program.list_vars()
                 if v.sharding))
    cached = getattr(program, '_mesh_spec_cache', None)
    if cached is not None and cached[0] == key:
        return cached[1]
    spec = None
    if dist_cfg is not None:
        for ax in ('tp', 'pp', 'sp'):
            if int(dist_cfg.get(ax + '_size') or 1) > 1:
                _not_ported('DistributeTranspiler with %s_size > 1' % ax)
        dp = min(int(dist_cfg.get('dp_size') or 1), world)
        if dp > 1 or (parallel._world() and dp == world):
            mesh = parallel.make_mesh({'dp': dp})
            spec = MeshSpec(program, mesh, 'dp', 'transpiler')
    elif axes_attr:
        axes = collections.OrderedDict(axes_attr)
        data_axis = program._mesh_data_axis
        big = [a for a, s in axes.items() if s > 1 and a != data_axis]
        if big and not (data_axis is False and len(big) == 1
                        and big[0] in ('dp', 'data')):
            _not_ported('a mesh with the non-data axis %r of size > 1 '
                        '(tensor, sequence or pipeline parallelism)'
                        % big[0])
        if int(np.prod(list(axes.values()))) > 1 or parallel._world():
            mesh = parallel.make_mesh(axes)
            spec = MeshSpec(program, mesh, data_axis, 'annotations')
    program._mesh_spec_cache = (key, spec)
    return spec


# -- feeds --------------------------------------------------------------------

def shard_feed(spec, name, value, var):
    """This rank's rows of one coerced feed value (a tensor or a SeqValue),
    or the value itself where the feed replicates: a scalar, a program whose
    data axis is False or absent, a feed var annotated without the data
    axis on dim 0. Returns (value, sharded)."""
    if spec.data_axis in (None, False):
        return value, False
    ann = getattr(var, 'sharding', None) if var is not None else None
    if ann is not None and (not ann or ann[0] != spec.data_axis):
        return value, False
    data = data_of(value)
    if data.ndim == 0:
        return value, False
    rows = data.shape[0]
    if rows % spec.n:
        raise ValueError(
            "feed %r global batch size %d is not divisible by the %r mesh "
            "axis size %d; drop the remainder (e.g. "
            "paddle.batch(..., drop_last=True))"
            % (name, rows, spec.data_axis, spec.n))
    if isinstance(value, SeqValue):
        return SeqValue(spec.block(value.data, 0),
                        spec.block(value.lengths, 0), value.outer_lengths,
                        beam_cap=value.beam_cap), True
    return spec.block(value, 0), True


# -- the plan of one step artifact -------------------------------------------

# ops that complete a batch reduction with an all_reduce of their result
_REDUCE_ALL = {'mean': 'avg'}
_REDUCE_DIMS = {'reduce_sum': 'sum', 'reduce_mean': 'avg'}
_GATHER_REDUCE_DIMS = ('reduce_max', 'reduce_min', 'reduce_prod',
                       'reduce_all', 'reduce_any')
# ops each of whose output rows depends only on the same rows of its
# batch-sharded inputs (their other inputs, parameters and constants, are
# read whole): the only ops that run on a rank's rows alone, outputs
# sharded. The attrs below send those of them that work over the batch
# axis to 'gather'. Random ops among them draw per rank.
_ROW_WISE = frozenset([
    # elementwise
    'abs', 'brelu', 'ceil', 'cos', 'elu', 'exp', 'floor', 'hard_shrink',
    'hard_sigmoid', 'leaky_relu', 'log', 'logsigmoid', 'pow', 'prelu',
    'reciprocal', 'relu', 'relu6', 'round', 'sigmoid', 'sign', 'sin',
    'soft_relu', 'softplus', 'softshrink', 'softsign', 'sqrt', 'square',
    'stanh', 'swish', 'tanh', 'tanh_shrink', 'thresholded_relu', 'scale',
    'clip', 'cast', 'assign', 'fill_zeros_like', 'dropout', 'sum', 'minus',
    'print', 'increment', 'label_smooth', 'one_hot',
    'fake_dequantize_max_abs', 'equal', 'not_equal', 'greater_equal',
    'greater_than', 'less_equal', 'less_than', 'logical_and', 'logical_not',
    'logical_or', 'logical_xor',
    # one row in, one row out
    'cross_entropy', 'softmax_with_cross_entropy',
    'sigmoid_cross_entropy_with_logits', 'log_loss', 'hinge_loss',
    'huber_loss', 'smooth_l1_loss', 'modified_huber_loss', 'rank_loss',
    'margin_rank_loss', 'squared_l2_distance', 'cos_sim',
    'bilinear_tensor_product', 'conv_shift', 'multiplex',
    'hierarchical_sigmoid', 'nce', 'sampling_id', 'lookup_table',
    'quant_lookup_table', 'flash_attention', 'maxout', 'lrn', 'softmax',
    'top_k', 'layer_norm', 'l2_normalize', 'norm', 'arg_max', 'arg_min',
    'argsort', 'cumsum', 'reverse', 'concat', 'split', 'stack', 'slice',
    'squeeze', 'unsqueeze', 'flatten',
    # one image a row
    'conv2d', 'conv2d_transpose', 'conv3d', 'conv3d_transpose', 'pool2d',
    'pool3d', 'max_pool2d_with_index', 'unpool', 'spp', 'bilinear_interp',
    'nearest_interp', 'im2sequence', 'random_crop',
    # one sequence a row
    'sequence_conv', 'sequence_pool', 'sequence_softmax', 'sequence_expand',
    'sequence_concat', 'sequence_reshape', 'sequence_slice',
    'sequence_erase', 'sequence_mask', 'row_conv', 'lstm', 'gru', 'lstmp',
    'gru_unit', 'lstm_unit', 'linear_chain_crf', 'crf_decoding', 'warpctc',
    'ctc_align',
    # tensor arrays: an entry holds the batch's rows
    'array_read', 'array_write', 'array_length',
])
# the attr (and the rule's default) naming the axes a row-wise op works
# over: the batch axis among them sends it to 'gather'
_AXES = {
    'softmax_with_cross_entropy': ('axis', -1), 'layer_norm':
    ('begin_norm_axis', 1), 'l2_normalize': ('axis', -1), 'norm':
    ('axis', 1), 'arg_max': ('axis', 0), 'arg_min': ('axis', 0),
    'argsort': ('axis', -1), 'cumsum': ('axis', -1), 'reverse':
    ('axis', None), 'concat': ('axis', 0), 'split': ('axis', -1), 'stack':
    ('axis', 0), 'slice': ('axes', None), 'squeeze': ('axes', None),
    'unsqueeze': ('axes', None), 'flatten': ('axis', 1),
}
# the outputs that carry the batch rows, where not every output does (batch
# norm's running stats and moe's auxiliary loss are replicated)
_ROW_SLOTS = {'batch_norm': ('Y',), 'moe_mlp': ('Out',)}
# ops whose outputs carry no batch axis even when an input does
_NO_BATCH = frozenset(['prior_box', 'density_prior_box', 'anchor_generator'])
# update rules that work on any block of their operands (elementwise)
_SLICE_SAFE = frozenset([
    'sgd', 'momentum', 'adam', 'adam_beta_pow_update', 'adagrad', 'adamax',
    'decayed_adagrad', 'rmsprop', 'adadelta', 'ftrl', 'scale',
    'elementwise_add',
    'elementwise_sub', 'elementwise_mul', 'elementwise_div', 'sum', 'sign',
    'clip', 'cast', 'assign', 'fill_zeros_like',
])


def _ndim(op, slot):
    vs = op.inputs.get(slot) or []
    return len(vs[0].shape) if vs and vs[0].shape is not None else None


def _hits0(dims, ndim):
    if dims is None:
        return True
    dims = dims if isinstance(dims, (list, tuple)) else [dims]
    return any(d == 0 or (ndim is not None and d + ndim == 0)
               for d in dims)


def _classify(op, sharded_in):
    """How an op with batch-sharded inputs `sharded_in` runs on a rank:
    'local' (row-wise: outputs sharded), 'sum' / 'avg' (all_reduce the
    local result), 'gather' (on the gathered global rows), 'bn', 'moe',
    'nobatch' (outputs replicated as computed). An op not known to be
    row-wise is 'gather': slower than needed at worst, never wrong."""
    t, a = op.type, op.attrs
    if t in _REDUCE_ALL:
        return _REDUCE_ALL[t]
    if t in _REDUCE_DIMS or t in _GATHER_REDUCE_DIMS:
        if a.get('reduce_all') or _hits0(a.get('dim'), _ndim(op, 'X')):
            return _REDUCE_DIMS.get(t, 'gather')
        return 'local'
    if t == 'batch_norm':
        return 'local' if a.get('is_test') else 'bn'
    if t == 'moe_mlp':
        return 'moe'
    if t in _NO_BATCH:
        return 'nobatch'
    if t.startswith('elementwise_'):
        return 'local'
    if t == 'transpose':
        return 'gather' if list(a.get('axis') or [0])[0] != 0 else 'local'
    if t == 'reshape':
        shape = list(a.get('shape') or [])
        return 'gather' if shape and shape[0] not in (0, -1) else 'local'
    if t == 'expand':
        return 'gather' if list(a.get('expand_times') or [1])[0] != 1 \
            else 'local'
    if t == 'pad':
        pads = list(a.get('paddings') or [0, 0])
        return 'gather' if any(pads[:2]) else 'local'
    if t == 'mul':
        return 'gather' if 'Y' in _slots_of(op, sharded_in) else 'local'
    if t == 'matmul':
        slots = _slots_of(op, sharded_in)
        if ('X' in slots and a.get('transpose_X') and _ndim(op, 'X') == 2) \
                or ('Y' in slots and not a.get('transpose_Y')
                    and _ndim(op, 'Y') == 2):
            return 'gather'
        return 'local'
    if t in ('fill_constant_batch_size_like', 'uniform_random_batch_size_like',
             'gaussian_random_batch_size_like'):
        return 'local' if a.get('input_dim_idx', 0) == 0 and \
            a.get('output_dim_idx', 0) == 0 else 'gather'
    if t not in _ROW_WISE:
        return 'gather'
    if t in _AXES:
        k, default = _AXES[t]
        axes = a.get(k, default)
        ndim = _ndim(op, next(iter(op.inputs), 'X'))
        if t in ('stack', 'unsqueeze') and ndim is not None:
            ndim += 1       # the axes index the output
        if axes is not None and _hits0(axes, ndim):
            return 'gather'
    return 'local'


def _slots_of(op, names):
    return {slot for slot, vs in op.inputs.items()
            if any(v.name in names for v in vs)}


def _sub_blocks(op):
    out = []
    for v in op.attrs.values():
        if hasattr(v, 'ops') and hasattr(v, 'idx'):
            out.append(v)
    blk = op.attrs.get('sub_block')
    if isinstance(blk, int):
        out.append(op.block.program.block(blk))
    return out


class MeshPlan(object):
    """The mesh half of one StepArtifact: which vars carry the sharded
    batch, how each op completes across the ranks, and the gradient and
    ZeRO collectives of the update (see the module docstring)."""

    def __init__(self, spec, ops, ad_idx, sharded_feeds, fetch_names):
        self.spec = spec
        self.placement = dict(spec.placement)
        self.sharded = set(sharded_feeds)
        self.kinds = {}
        for i, op in enumerate(ops):
            if op.type == 'autodiff':
                continue
            ins = {n for n in op.input_arg_names if n in self.sharded}
            if not ins:
                continue
            subs = _sub_blocks(op)
            if subs:
                for blk in subs:
                    for sop in blk.ops:
                        if sop.input_arg_names and _classify(
                                sop, set(sop.input_arg_names)) != 'local':
                            _not_ported('the block op %r (whose %r mixes '
                                        'batch rows) on a dp mesh'
                                        % (op.type, sop.type))
                kind = 'local'
            else:
                kind = _classify(op, ins)
            if kind != 'local':
                self.kinds[i] = kind
            rows = _ROW_SLOTS.get(op.type) if kind in ('local', 'bn', 'moe') \
                else ()
            for slot, vs in op.outputs.items():
                row = slot in rows if rows is not None else True
                for v in vs:
                    if not row:
                        continue
                    if v.persistable:
                        _not_ported('op %r writing the persistable %r from '
                                    'batch rows on a dp mesh'
                                    % (op.type, v.name))
                    self.sharded.add(v.name)
        self.fetch_gather = [n in self.sharded for n in fetch_names]
        # ZeRO-2: gradients reduce-scattered to the block of their
        # parameter's accumulators, when only the update op reads them
        self.scatter_grads = {}
        if ad_idx is not None:
            ad = ops[ad_idx]
            gnames = dict(zip(ad.attrs['param_names'],
                              ad.attrs['grad_names']))
            readers = collections.defaultdict(list)
            for i, op in enumerate(ops):
                for n in set(op.input_arg_names):
                    readers[n].append(i)
            for p, g in gnames.items():
                if p in self.placement or len(readers[g]) != 1:
                    continue
                op = ops[readers[g][0]]
                if op.type not in _SLICE_SAFE or g not in op.input('Grad'):
                    continue
                dims = {self.placement[v.name] for vs in op.inputs.values()
                        for v in vs if v.name in self.placement}
                if len(dims) == 1:
                    self.scatter_grads[g] = dims.pop()
        self.fetch_names = list(fetch_names)
        self.fwd_reads = set()
        for op in ops[:len(ops) if ad_idx is None else ad_idx]:
            self.fwd_reads.update(op.input_arg_names)
            for blk in _sub_blocks(op):
                for sop in blk.ops:
                    self.fwd_reads.update(sop.input_arg_names)
        self._gathered = set()
        self._dyn = {}

    # -- collectives of values --------------------------------------------

    def _gather_rows(self, v, grad_op='sum'):
        g = self.spec.group
        if isinstance(v, SeqValue):
            if v.outer_lengths:
                _not_ported('gathering a nested LoD value across ranks')
            return SeqValue(_comm.all_gather(v.data, 0, g, grad_op),
                            _comm.all_gather(v.lengths, 0, g),
                            None, beam_cap=v.beam_cap)
        return _comm.all_gather(v, 0, g, grad_op)

    # -- the forward ----------------------------------------------------

    def gather_placed(self, env, leaves):
        """At the start of the forward, every persistable held as a block
        that the forward reads becomes its full value: a parameter through
        the differentiable gather (its gradient comes back
        reduce-scattered and averaged), any other without a gradient."""
        g = self.spec.group
        self._gathered = set()
        self._dyn = {}
        for n, dim in self.placement.items():
            if n not in env or n not in self.fwd_reads:
                continue
            if n in leaves:
                env[n] = _comm.all_gather(leaves[n], dim, g, 'avg')
            else:
                with torch.no_grad():
                    env[n] = _comm.all_gather(env[n], dim, g)
            self._gathered.add(n)

    def cut_placed(self, env, leaves):
        """After the forward: a persistable held as a block is its block
        again (a parameter: its leaf), for the update and the scope."""
        for n in self._gathered:
            if n in leaves:
                env[n] = leaves[n].detach()
            else:
                env[n] = self.spec.block(env[n], self.placement[n])

    def run_op(self, i, op, env, ctx, update=False):
        kind = self.kinds.get(i)
        if kind is None:
            blocks = self._blocks(op) if update else None
            if blocks:
                self._run_sliced(op, env, ctx, blocks)
            else:
                run_op(op, env, ctx)
            return
        g = self.spec.group
        if kind in ('sum', 'avg'):
            run_op(op, env, ctx)
            for vs in op.outputs.values():
                for v in vs:
                    val = env.get(v.name)
                    if isinstance(val, torch.Tensor):
                        env[v.name] = _comm.all_reduce(val, kind, g)
        elif kind == 'gather':
            local = dict(env)
            # in the op's order: every rank runs the same collectives in
            # the same sequence (a set's order varies with the process)
            for n in dict.fromkeys(op.input_arg_names):
                if n in self.sharded:
                    local[n] = self._gather_rows(env[n])
            run_op(op, local, ctx)
            for vs in op.outputs.values():
                for v in vs:
                    if v.name in local:
                        env[v.name] = local[v.name]
        elif kind == 'bn':
            _batch_norm(op, env, ctx, g)
        elif kind == 'moe':
            run_op(op, env, ctx.derive(mesh=self.spec.mesh))
        else:   # 'nobatch'
            run_op(op, env, ctx)

    # -- the update -----------------------------------------------------

    def _blocks(self, op):
        """{name: dim} of the op's inputs held as blocks in the update."""
        out = {}
        for n in set(op.input_arg_names):
            for table in (self.placement, self.scatter_grads, self._dyn):
                if n in table:
                    out[n] = table[n]
                    break
        return out

    def _run_sliced(self, op, env, ctx, blocks):
        """An update op over blocks: its full-size operands are cut to this
        rank's block and it runs; an output whose var came in at full size
        (a replicated parameter under ZeRO-1/2) is gathered back, any other
        stays a block."""
        dims = set(blocks.values())
        if len(dims) != 1:
            _not_ported('op %r over blocks of different dims %r'
                        % (op.type, blocks))
        if op.type not in _SLICE_SAFE:
            _not_ported('op %r over ZeRO blocks (only elementwise update '
                        'ops run on a block)' % op.type)
        dim = dims.pop()
        # the update's reference shape: its parameter's, else its largest
        # block's
        params = op.inputs.get('Param') or []
        if params and params[0].shape is not None:
            full = tuple(params[0].shape)
            bshape = full[:dim] + (full[dim] // self.spec.n,) + full[dim + 1:]
        else:
            bshape = max((tuple(env[n].shape) for n in blocks),
                         key=lambda s: int(np.prod(s)))
            full = bshape[:dim] + (bshape[dim] * self.spec.n,) \
                + bshape[dim + 1:]
        local = dict(env)
        cut = set()
        for n in set(op.input_arg_names) - set(blocks):
            val = local.get(n)
            if isinstance(val, torch.Tensor) and tuple(val.shape) == full:
                local[n] = self.spec.block(val, dim)
                cut.add(n)
        run_op(op, local, ctx)
        for vs in op.outputs.values():
            for v in vs:
                val = local.get(v.name)
                if val is None:
                    continue
                if v.name in cut:
                    val = _comm.all_gather(val, dim, self.spec.group)
                elif (v.name not in self.placement
                      and isinstance(val, torch.Tensor)
                      and tuple(val.shape) == bshape):
                    self._dyn[v.name] = dim
                env[v.name] = val

    def reduce_grads(self, env, grads):
        """Average the replicated parameters' gradients over the ranks
        ({grad name: tensor}, in place of env): ZeRO-2 gradients are
        reduce-scattered to their block, the rest all-reduced in buckets of
        at most 25 MiB of one dtype."""
        g = self.spec.group
        bucket, size, dtype = [], 0, None

        def flush():
            if not bucket:
                return
            flat = torch.cat([env[n].reshape(-1) for n in bucket])
            flat = _comm.all_reduce(flat, 'avg', g)
            off = 0
            for n in bucket:
                k = env[n].numel()
                env[n] = flat[off:off + k].view(env[n].shape)
                off += k
            del bucket[:]

        for n in grads:
            t = env[n]
            if n in self.scatter_grads:
                env[n] = _comm.reduce_scatter(t, self.scatter_grads[n],
                                              'avg', g)
                continue
            nbytes = t.numel() * t.element_size()
            if bucket and (t.dtype != dtype or size + nbytes > _BUCKET_BYTES):
                flush()
                size = 0
            bucket.append(n)
            size += nbytes
            dtype = t.dtype
        flush()

    def global_sum(self, t):
        """All-reduce (sum) of a local partial sum (the health vector's
        over gradient blocks)."""
        return _comm.all_reduce(t, 'sum', self.spec.group)

    def gather_fetches(self, fetches, env):
        """Every rank's fetches as the JAX step returns them: batch-sharded
        values and blocks gathered to their global values."""
        out = []
        with torch.no_grad():
            for n, v, rows in zip(self.fetch_names, fetches,
                                  self.fetch_gather):
                if rows:
                    v = self._gather_rows(v)
                elif isinstance(v, torch.Tensor):
                    for table in (self.placement, self.scatter_grads,
                                  self._dyn):
                        if n in table:
                            v = _comm.all_gather(v, table[n],
                                                 self.spec.group)
                            break
                out.append(v)
        return out


def _batch_norm(op, env, ctx, group):
    """batch_norm in training over the global batch (the JAX rule's mean
    over axis 0 of the sharded array): mean and biased variance are the
    averages over the ranks of each rank's means (every rank holds as many
    rows), Y normalizes this rank's rows with them, and the running stats
    update from them as the single-device rule's do."""
    ins = {slot: [env[v.name] for v in vs] for slot, vs in op.inputs.items()}
    a = op.attrs
    x = data_of(ins['X'][0])
    scale = data_of(ins['Scale'][0]).to(torch.float32)
    bias = data_of(ins['Bias'][0]).to(torch.float32)
    mean = data_of(ins['Mean'][0])
    var = data_of(ins['Variance'][0])
    eps = a.get('epsilon', 1e-5)
    momentum = a.get('momentum', 0.9)
    c_axis = 1 if a.get('data_layout', 'NCHW') == 'NCHW' else x.ndim - 1
    axes = tuple(i for i in range(x.ndim) if i != c_axis)
    shape = [1] * x.ndim
    shape[c_axis] = x.shape[c_axis]
    xf = x.to(torch.float32)
    b_mean = _comm.all_reduce(xf.mean(dim=axes), 'avg', group)
    d = xf - b_mean.view(shape)
    b_var = _comm.all_reduce((d * d).mean(dim=axes), 'avg', group)
    y = d * torch.rsqrt(b_var + eps).view(shape) * scale.view(shape) \
        + bias.view(shape)
    with torch.no_grad():
        mean_out = mean * momentum + b_mean.detach() * (1 - momentum)
        var_out = var * momentum + b_var.detach() * (1 - momentum)
    outs = {'Y': y.to(x.dtype), 'MeanOut': mean_out, 'VarianceOut': var_out,
            'SavedMean': b_mean, 'SavedVariance': b_var}
    for slot, vs in op.outputs.items():
        if slot in outs and vs:
            env[vs[0].name] = outs[slot]


def full_state(program, scope):
    """{name: full tensor} of `program`'s scope-initialized persistables:
    a value the scope holds as this rank's block (place_scope's record) is
    all-gathered (every rank must call it)."""
    blocks = getattr(scope, '_mesh_blocks', {})
    out = {}
    for v in program.list_vars():
        if not v.persistable:
            continue
        val = scope._chain_get(v.name)
        if val is None or isinstance(val, SeqValue):
            continue
        rec = blocks.get(v.name)
        if rec is not None and tuple(val.shape) != rec[1]:
            val = _comm.all_gather(val.detach(), rec[0], rec[2])
        out[v.name] = val
    return out


def place_scope(spec, program, scope):
    """Hold every placed persistable of the scope as this rank's block: a
    value at its full shape (from the startup program, io.load, a user
    write) is cut; a block is left alone. The scope records each block's
    dim, full shape and group (`_mesh_blocks`, which full_state reads)."""
    if spec is None:
        return
    rec = scope.__dict__.setdefault('_mesh_blocks', {})
    for n, dim in spec.placement.items():
        val = scope._chain_get(n)
        if not isinstance(val, torch.Tensor):
            continue
        rec[n] = (dim, spec.full_shapes[n], spec.group)
        if tuple(val.shape) == spec.full_shapes[n] and spec.n > 1:
            scope._chain_set(n, spec.block(val, dim).contiguous().clone())
