"""Structured control flow: the sub-block ops and the tensor-array rules.

Parity: the JAX package's fluid/ops_impl/block_ops.py (reference
paddle/fluid/operators/{while_op.cc, conditional_block_op.cc,
recurrent_op.cc, array_write_op.cc} and the layers of
layers/control_flow.py). A block op's rule runs its sub-block(s) through
lowering.run_block over a copy of the environment:

  * `while`: a bounded loop with predicated carries (below);
  * `static_rnn`: a Python loop over the leading (time) axis, as the JAX
    rule's lax.scan;
  * `dynamic_rnn`: a Python loop over the padded time axis of
    [batch, T, ...] sequences, each memory update kept only where the
    step is inside the row's sequence (torch.where, the JAX _pred_where;
    a select, not an arithmetic mask, so a NaN past a row's end stays
    out of the carry);
  * `ifelse` / `switch`: every branch runs, the outputs merge by a
    predicated select.

The LoDTensorArray is lowering.ArrayValue: a fixed-capacity device buffer
and a live length, so an array is a legal loop carry and a captured graph
sees static shapes.

How a `while` runs. JAX lowers an unbounded While to lax.while_loop,
whose condition XLA evaluates on the device. A CUDA graph has no such
node that torch builds for us, and the warm-up of a captured step runs
under torch.cuda.set_sync_debug_mode('error') (fluid/step_artifact.py),
so a loop that read its condition on the host would raise there and could
not be captured. So every `while`, on the CPU and on the card, runs as
the JAX package's bounded form (:239-250): a static number of iterations,
each carry update kept only where the device-side condition held at the
start of the iteration, with no host read. Eager walks, the warm-up and
the capture run this one code path. The bound is the op's `max_iters`
where given, else the least capacity among the arrays the loop carries
(a loop cannot write more slots than its arrays hold), else
lowering.DEFAULT_ARRAY_CAPACITY. After the loop the rule appends its
condition's final value, a device tensor, to ctx.loops; the step artifact
reads those flags on the host with the fetches and raises RuntimeError,
naming the op, its bound and the remedy, when one is still true. The JAX
package's unbounded loop would run on instead; the port never returns a
truncated result. The iterations past the condition's fall run the body
all the same (their updates are discarded): that is the price of a
static graph, and phase 7f of chip_smoke.py measures it.

Random ops in a loop body draw fresh bits every iteration: the executor's
generator advances with each draw (JAX folds the iteration into the key,
_iter_ctx :35-40, so the bits differ between the packages; in both the
masks differ from one iteration to the next).
"""
import warnings

import torch

from ..core import torch_dtype
from ..lowering import (ArrayValue, DEFAULT_ARRAY_CAPACITY, SeqValue,
                        data_of, leaves_of, register, register_block_op,
                        run_block)


def _scalar_bool(c):
    """The first element of a condition as a 0-d device bool (a view and
    a cast: no host read)."""
    return data_of(c).reshape(-1)[0].to(torch.bool)


def _align(c, x):
    """cond c broadcast against value x the JAX way: trailing singleton
    dims squeezed or appended to x's rank."""
    while c.ndim > x.ndim:
        c = c.squeeze(-1)
    while c.ndim < x.ndim:
        c = c.unsqueeze(-1)
    return c


def _pred_where(cond, a, b):
    """where(cond, a, b) over every tensor of a value (a SeqValue's or an
    ArrayValue's leaves), cond aligned to each (the JAX :43-52)."""
    def one(x, y):
        return torch.where(_align(cond, x), x, y)
    if isinstance(a, ArrayValue):
        leaves = [one(x, y) for x, y in zip(a.leaves, b.leaves)]
        return a.with_leaves(leaves, one(a.length, b.length))
    if isinstance(a, SeqValue):
        return a.with_leaves(one(x, y) for x, y in zip(leaves_of(a),
                                                       leaves_of(b)))
    return one(a, b)


def _to_meta(v):
    """A value with every tensor replaced by a meta tensor of its shape
    and dtype (the body's shape run: the JAX jax.eval_shape)."""
    meta = lambda t: torch.empty_like(t, device='meta') \
        if isinstance(t, torch.Tensor) else t
    if isinstance(v, ArrayValue):
        return v.with_leaves([meta(t) for t in v.leaves], meta(v.length))
    if isinstance(v, SeqValue):
        return v.with_leaves(meta(t) for t in leaves_of(v))
    return meta(v)


# ---------------------------------------------------------------------------
# LoDTensorArray ops
# ---------------------------------------------------------------------------

def _index(ins):
    return data_of(ins['I'][0]).reshape(-1)[0]


@register('array_write')
def _array_write(ins, attrs, ctx):
    """Slot I of the array <- X (the JAX :59-81). A write past the
    capacity clamps to the last slot, as in JAX; JAX prints a warning
    there on the device. The port warns only where the index is already
    on the host (a CPU walk, in a live iteration): a step on the card never
    reads it."""
    x = ins['X'][0]
    if not isinstance(x, SeqValue):
        x = data_of(x)
    i = _index(ins)
    arrs = ins.get('Array', [])
    if arrs and isinstance(arrs[0], ArrayValue):
        arr = arrs[0]
    else:
        arr = ArrayValue.fresh(x, int(attrs.get('capacity',
                                                DEFAULT_ARRAY_CAPACITY)))
    cap = arr.capacity
    if i.device.type == 'cpu' and int(i) >= cap and (
            ctx.pred is None or bool(ctx.pred)):
        warnings.warn(
            'array_write index %d >= capacity %d; write clamped to the '
            'last slot: pass capacity= to create_array/array_write for '
            'longer loops' % (int(i), cap))
    return {'Out': arr.write(i, x, ctx.pred, ctx.inplace)}


@register('array_read')
def _array_read(ins, attrs, ctx):
    return {'Out': ins['Array'][0].read(_index(ins))}


@register('array_length')
def _array_length(ins, attrs, ctx):
    return {'Out': ins['Array'][0].length.reshape(1).to(torch.int64)}


@register('array_stack')
def _array_stack(ins, attrs, ctx):
    """The array as one [capacity, ...] tensor (the JAX :97-104; backs
    contrib's BeamSearchDecoder). Slots never written are zeros. A copy:
    a later in-place write to the array leaves it as it is."""
    arr = ins['Array'][0]
    return {'Out': arr.leaves[0].clone()}


# ---------------------------------------------------------------------------
# while
# ---------------------------------------------------------------------------

# the stride-widening convention (rows move to block starts) is defined
# once, in lowering.ArrayValue._grow_rows
_widen_rows = ArrayValue._grow_rows


def _widen_array(a, target):
    """Widen an initial ArrayValue to the shapes and structure the loop
    body produces (`target`: the body's shape run, an ArrayValue of meta
    tensors); the result adopts target's beam flag (the JAX :116-165)."""
    n_src = (target.buffer[2].shape[1]
             if target.is_seq and target.n_outer >= 1 else None)
    if target.is_seq and not a.is_seq:
        # the pre-loop write was dense (the encoder state fed into the
        # state array); the body writes LoD values: adopt the LoD layout
        # with the dense rows as one-row-per-source groups
        data_t, len_t = target.buffer[0], target.buffer[1]
        data = _widen_rows(a.buffer, data_t.shape[1], n_sources=n_src)
        stride = data_t.shape[1] // a.buffer.shape[1]
        lens = torch.zeros(tuple(len_t.shape), dtype=len_t.dtype,
                           device=data.device)
        lens[:, ::stride] = 1
        outer = tuple(torch.ones(tuple(ob.shape), dtype=ob.dtype,
                                 device=data.device)
                      for ob in target.buffer[2:2 + target.n_outer])
        return ArrayValue((data, lens) + outer, a.length, target.n_outer,
                          beam=target.beam)
    if a.is_seq:
        data_t = target.buffer[0]
        d0 = a.buffer[0]
        if d0.ndim == data_t.ndim + 1 and d0.shape[2] == 1:
            # the padded 2-level feed form [B, max_len=1, ...] (the book's
            # init_ids / init_scores) -> the flat capacity row form
            d0 = d0.reshape(tuple(d0.shape[:2]) + tuple(d0.shape[3:]))
        if tuple(d0.shape) != tuple(data_t.shape):
            data = _widen_rows(d0, data_t.shape[1], n_sources=n_src)
            lens = _widen_rows(a.buffer[1], target.buffer[1].shape[1],
                               n_sources=n_src)
            return ArrayValue((data, lens) + tuple(a.buffer[2:]), a.length,
                              a.n_outer, beam=target.beam)
        if d0 is not a.buffer[0] or a.beam != target.beam:
            return ArrayValue((d0,) + tuple(a.buffer[1:]), a.length,
                              a.n_outer, beam=target.beam)
        return a
    if tuple(a.buffer.shape) != tuple(target.buffer.shape):
        return ArrayValue(_widen_rows(a.buffer, target.buffer.shape[1]),
                          a.length, -1, beam=target.beam)
    return a


def _widen_carry_to_body(init, shape_run):
    """Fixed-point capacity widening (the book's LoD beam decoder idiom,
    the JAX :168-200): pre-loop writes may be narrower than what the body
    produces (init_ids holds one row per source, beam_search emits
    beam_size per source). The loop's carries must keep their shapes, so
    run the body on meta tensors and widen the INITIAL arrays to its
    shapes (rows placed by the beam-block convention) until stable."""
    for _ in range(4):
        try:
            target = shape_run(init)
        except Exception:   # noqa: BLE001 - the real run raises it again
            return init
        changed = False
        out = {}
        for n, v in init.items():
            t = target.get(n)
            if isinstance(v, ArrayValue) and isinstance(t, ArrayValue):
                w = _widen_array(v, t)
                changed = changed or (w is not v)
                out[n] = w
            elif (isinstance(v, SeqValue) and isinstance(t, SeqValue)
                  and v.beam_cap != t.beam_cap):
                # a directly carried SeqValue that the body turns into the
                # capacity form enters the loop flagged as it leaves
                out[n] = SeqValue(v.data, v.lengths, v.outer_lengths,
                                  beam_cap=t.beam_cap)
                changed = True
            else:
                out[n] = v
        init = out
        if not changed:
            return init
    raise ValueError(
        'While: loop-carried shapes did not stabilize after capacity '
        'widening: the body grows an array on every iteration, which a '
        'static graph cannot hold; restructure the loop with static shapes')


def _loop_bound(op, init):
    """max_iters, else the least capacity among the carried arrays, else
    DEFAULT_ARRAY_CAPACITY."""
    max_iters = op.attrs.get('max_iters')
    if max_iters:
        return int(max_iters)
    caps = [v.capacity for v in init.values() if isinstance(v, ArrayValue)]
    return min(caps) if caps else DEFAULT_ARRAY_CAPACITY


def while_label(op):
    """How the end check names a while op: its index in its block."""
    blk = op.block
    return 'while op #%d of block %d' % (blk.ops.index(op), blk.idx)


@register_block_op('while')
def _while(op, env, ctx):
    prog = op.block.program
    sub = prog.block(op.attrs['sub_block'])
    cond_name = op.inputs['Condition'][0].name
    carry_names = [v.name for v in op.outputs['Out']]
    missing = [n for n in carry_names if n not in env]
    if missing:
        raise ValueError(
            "While: loop-carried vars %s must be written (e.g. array_write / "
            "fill_constant) before the loop so their shapes are known"
            % missing)
    outer = dict(env)
    init = {n: env[n] for n in carry_names}

    def get_cond(carry):
        # a bounded loop's body may leave cond alone: the outer value holds
        return carry[cond_name] if cond_name in carry else outer[cond_name]

    def body(carry, bctx, base=outer):
        e = dict(base)
        e.update(carry)
        run_block(sub, e, bctx)
        return {n: e[n] for n in carry_names}

    def shape_run(carry):
        meta_outer = {n: _to_meta(v) for n, v in outer.items()}
        meta = {n: _to_meta(v) for n, v in carry.items()}
        return body(meta, ctx.derive(device=torch.device('meta'),
                                     generator=None, pred=None, loops=None),
                    meta_outer)

    if any(isinstance(v, ArrayValue) for v in init.values()):
        init = _widen_carry_to_body(init, shape_run)
    if ctx.device.type == 'meta':
        # shape inference: one trip of the body gives the carries' shapes
        env.update(body(init, ctx))
        return

    bound = _loop_bound(op, init)
    carry = init
    for _ in range(bound):
        alive = _scalar_bool(get_cond(carry))
        if ctx.pred is not None:
            alive = alive & ctx.pred
        new = body(carry, ctx.derive(pred=alive))
        merged = {}
        for n in carry_names:
            old, v = carry[n], new[n]
            if isinstance(v, ArrayValue):
                # its writes took effect only where `alive` held
                merged[n] = v
                continue
            if isinstance(old, torch.Tensor) and isinstance(v, torch.Tensor) \
                    and v.dtype != old.dtype:
                v = v.to(old.dtype)
            merged[n] = _pred_where(alive, v, old)
        carry = merged
    running = _scalar_bool(get_cond(carry))
    if ctx.pred is not None:
        running = running & ctx.pred
    if ctx.loops is not None:
        ctx.loops.append((while_label(op), bound, running))
    env.update(carry)


def pack_loops(loops):
    """ctx.loops' (label, bound, flag) records as ((label, bound), ...) and
    one bool tensor of the flags (built inside the step, so a captured
    graph writes it on every replay), or None when no while ran."""
    if not loops:
        return None
    return (tuple((label, bound) for label, bound, _ in loops),
            torch.stack([f.reshape(()) for _, _, f in loops]))


def check_loops(packed):
    """Raise RuntimeError for the first while whose condition still held
    after its bound (`packed`: pack_loops' result). One host read for all
    of them."""
    if packed is None:
        return
    labels, flags = packed
    for (label, bound), still in zip(labels, flags.cpu().tolist()):
        if still:
            raise RuntimeError(
                '%s still had its condition true after its bound of %d '
                'iterations: the loop runs to a static bound, and past it '
                'the result would be truncated. Give the loop more room: '
                'While(cond, max_iters=N), or capacity=N on the '
                'create_array / array_write of the arrays it carries'
                % (label, bound))


# ---------------------------------------------------------------------------
# ifelse / switch  (predicated select)
# ---------------------------------------------------------------------------

@register_block_op('ifelse')
def _ifelse(op, env, ctx):
    """Both branches run; the outputs merge by a predicated select (the
    JAX :262-291). A branch's outer writes (`OuterOut`: an assign to an
    outer var) merge the same way; a var a branch leaves alone keeps its
    pre-if value on that side. As in JAX, a NaN the untaken branch
    computes poisons the gradient of the inputs it shares (0 * NaN in
    the cotangent): guard the input inside the branch."""
    prog = op.block.program
    t_idx, f_idx = op.attrs['sub_blocks']
    cond = data_of(env[op.inputs['Cond'][0].name])
    bctx = ctx.derive(inplace=False)
    te = dict(env)
    run_block(prog.block(t_idx), te, bctx)
    fe = dict(env)
    run_block(prog.block(f_idx), fe, bctx)
    for out_var, tn, fn in zip(op.outputs['Out'], op.attrs['true_outs'],
                               op.attrs['false_outs']):
        env[out_var.name] = _pred_where(cond, data_of(te[tn]),
                                        data_of(fe[fn]))
    for v in op.outputs.get('OuterOut', []):
        n = v.name
        env[n] = _pred_where(cond, data_of(te.get(n, env[n])),
                             data_of(fe.get(n, env[n])))


@register_block_op('switch')
def _switch(op, env, ctx):
    """Every case runs; the first true condition wins, the default case
    (last) is the base (the JAX :294-328)."""
    prog = op.block.program
    cond_names = op.attrs['cond_names']   # '' marks the default case
    case_writes = op.attrs['case_writes']
    bctx = ctx.derive(inplace=False)
    case_envs = []
    for bidx in op.attrs['sub_blocks']:
        e = dict(env)
        run_block(prog.block(bidx), e, bctx)
        case_envs.append(e)
    has_default = '' in cond_names
    for out_var in op.outputs['Out']:
        n = out_var.name
        val = env.get(n)
        if val is None and not (has_default and
                                n in case_writes[cond_names.index('')]):
            raise ValueError(
                "Switch: %r is only written in conditional cases and has no "
                "prior value or default-case write to fall back to" % n)
        for cn, writes, e in reversed(list(zip(cond_names, case_writes,
                                               case_envs))):
            if n not in writes:
                continue
            if cn == '':
                val = e[n]
            else:
                val = _pred_where(data_of(env[cn]), e[n], val)
        env[n] = val


# ---------------------------------------------------------------------------
# static_rnn  (a loop over the leading / time axis)
# ---------------------------------------------------------------------------

def _stack_steps(ys, t, axis):
    """The per-step outputs stacked on `axis`; on meta tensors (one step
    run) the one step repeated t times."""
    if len(ys) == 1 and t != 1:
        y = ys[0].unsqueeze(axis)
        shape = list(y.shape)
        shape[axis] = t
        return y.expand(shape)
    return torch.stack(ys, axis)


@register_block_op('static_rnn')
def _static_rnn(op, env, ctx):
    """The JAX :335-362: the sub-block once a step of the leading axis,
    the memories carried, the step outputs stacked on a new leading
    axis. On meta tensors the step runs once."""
    prog = op.block.program
    sub = prog.block(op.attrs['sub_block'])
    step_ins = op.attrs['step_ins']     # [(outer, inner)]
    mems = op.attrs['mems']             # [{'pre','init','upd'}]
    outs = op.attrs['outs']             # [(inner, outer)]
    xs = [data_of(env[o]) for o, _ in step_ins]
    carry = [env[m['init']] for m in mems]
    outer = dict(env)
    T = xs[0].shape[0]
    steps = 1 if ctx.device.type == 'meta' else T
    # a step's writes to an outer array stay in the step, as in JAX
    bctx = ctx.derive(inplace=False)
    ys = [[] for _ in outs]
    for t in range(steps):
        e = dict(outer)
        for (_, inner), x in zip(step_ins, xs):
            e[inner] = x[t]
        for m, c in zip(mems, carry):
            e[m['pre']] = c
        run_block(sub, e, bctx)
        carry = [e[m['upd']] for m in mems]
        for y, (inner, _) in zip(ys, outs):
            y.append(data_of(e[inner]))
    for y, (_, outer_name) in zip(ys, outs):
        env[outer_name] = _stack_steps(y, T, 0)


# ---------------------------------------------------------------------------
# dynamic_rnn  (a loop over padded [batch, T, ...] with length masking)
# ---------------------------------------------------------------------------

@register_block_op('dynamic_rnn')
def _dynamic_rnn(op, env, ctx):
    """The JAX :369-427: the sub-block once a step of the padded time
    axis; each memory update kept where the step is inside the row's
    sequence (a select, the JAX _pred_where), the floating step outputs
    zeroed past each row's length by a multiply (as the JAX rule does),
    stacked into a sequence of the input's lengths."""
    prog = op.block.program
    sub = prog.block(op.attrs['sub_block'])
    step_ins = op.attrs['step_ins']
    static_ins = op.attrs['static_ins']
    mems = op.attrs['mems']             # [{'pre','init','value','shape','upd'}]
    outs = op.attrs['outs']
    seq0 = env[step_ins[0][0]]
    if not isinstance(seq0, SeqValue):
        raise ValueError("DynamicRNN.step_input expects a lod_level>0 "
                         "sequence var (padded dense + lengths)")
    lengths = seq0.lengths
    B, T = seq0.data.shape[0], seq0.data.shape[1]
    xs = [data_of(env[o]) for o, _ in step_ins]
    carry = []
    for m in mems:
        if m.get('init'):
            carry.append(data_of(env[m['init']]))
        else:
            shape = (B,) + tuple(m.get('shape') or ())
            carry.append(torch.full(
                shape, float(m.get('value', 0.0)),
                dtype=torch_dtype(m.get('dtype', 'float32')),
                device=seq0.data.device))
    outer = dict(env)
    steps = 1 if ctx.device.type == 'meta' else T
    bctx = ctx.derive(inplace=False)
    ys = [[] for _ in outs]
    for t in range(steps):
        e = dict(outer)
        for (_, inner), x in zip(step_ins, xs):
            e[inner] = x[:, t]
        for o, inner in static_ins:
            e[inner] = outer[o]
        for m, c in zip(mems, carry):
            e[m['pre']] = c
        run_block(sub, e, bctx)
        active = lengths > t            # [B]
        carry = [_pred_where(active, data_of(e[m['upd']]), c)
                 for m, c in zip(mems, carry)]
        for y, (inner, _) in zip(ys, outs):
            y.append(data_of(e[inner]))
    for y, (_, outer_name) in zip(ys, outs):
        y = _stack_steps(y, T, 1)       # [B, T, ...]
        if y.is_floating_point():
            steps_t = torch.arange(T, device=lengths.device)
            mask = steps_t[None, :] < lengths[:, None]
            y = y * mask.reshape(tuple(mask.shape) + (1,) * (y.ndim - 2)
                                 ).to(y.dtype)
        env[outer_name] = SeqValue(y, lengths)
