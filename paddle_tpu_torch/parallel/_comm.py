"""Collectives over a torch.distributed process group, with the autograd
rules the mesh step differentiates through.

One process runs one rank. A value is either REPLICATED (every rank holds
the same tensor and computes the same thing from it) or SHARDED (each rank
holds its own rows of a larger global tensor). The step seeds its loss
gradient with 1 on every rank and averages the parameters' gradients across
ranks at the end, so a replicated value's cotangent is its true cotangent
and a sharded value's is N times its true one (N the group's size). Each
collective's backward keeps that invariant, whatever mix of replicated and
sharded uses its output has:

  * all_reduce(op='sum' or 'avg'): backward is the same all_reduce;
  * all_gather (sharded rows -> replicated global tensor): backward is a
    reduce_scatter, summing ('sum', for activations) or averaging ('avg',
    for a parameter's shard, whose gradient is then the finished average);
  * reduce_scatter: backward is an all_gather;
  * all_to_all: backward is the all_to_all back;
  * ppermute: backward is the inverse permutation.

NCCL offers ReduceOp.AVG; gloo does not, and there an average is a sum
divided by N. Every call runs on the current stream's order (the process
group enqueues on its own stream, joined to the caller's by events), so a
step captured into a CUDA graph captures its collectives with it.
"""
import torch
import torch.distributed as dist

__all__ = ['all_reduce', 'all_gather', 'reduce_scatter', 'all_to_all',
           'ppermute', 'group_size', 'group_rank']


# torch 2.13 renamed the tensor forms (the old names warn there)
_all_gather_tensor = getattr(dist, 'all_gather_single', None) or \
    dist.all_gather_into_tensor
_reduce_scatter_tensor = getattr(dist, 'reduce_scatter_single', None) or \
    dist.reduce_scatter_tensor


def group_size(group):
    return dist.get_world_size(group)


def group_rank(group):
    return dist.get_rank(group)


def _has_avg(group):
    return dist.get_backend(group) == 'nccl'


def _reduce_(t, op, group):
    """In-place all_reduce of a contiguous tensor: 'sum', 'avg', 'max' or
    'min'."""
    if op == 'avg':
        if _has_avg(group):
            dist.all_reduce(t, op=dist.ReduceOp.AVG, group=group)
        else:
            dist.all_reduce(t, group=group)
            t.div_(group_size(group))
        return t
    dist.all_reduce(t, op={'sum': dist.ReduceOp.SUM,
                           'max': dist.ReduceOp.MAX,
                           'min': dist.ReduceOp.MIN}[op], group=group)
    return t


def _gather(x, dim, group):
    n = group_size(group)
    xm = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * xm.shape[0],) + tuple(xm.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _all_gather_tensor(out, xm, group=group)
    return out.movedim(0, dim)


def _scatter(x, dim, op, group):
    n = group_size(group)
    xm = x.movedim(dim, 0).contiguous()
    if xm.shape[0] % n:
        raise ValueError('reduce_scatter: dim %d of size %d does not split '
                         'over %d ranks' % (dim, xm.shape[0], n))
    out = torch.empty((xm.shape[0] // n,) + tuple(xm.shape[1:]),
                      dtype=x.dtype, device=x.device)
    if op == 'avg' and _has_avg(group):
        _reduce_scatter_tensor(out, xm, op=dist.ReduceOp.AVG,
                               group=group)
    else:
        _reduce_scatter_tensor(out, xm, group=group)
        if op == 'avg':
            out.div_(n)
    return out.movedim(0, dim)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, op, group):
        ctx.op, ctx.group = op, group
        return _reduce_(
            x.detach().clone(memory_format=torch.contiguous_format), op,
            group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_(g.contiguous().clone(), ctx.op, ctx.group), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, grad_op, group):
        ctx.dim, ctx.grad_op, ctx.group = dim, grad_op, group
        return _gather(x.detach(), dim, group)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g, ctx.dim, ctx.grad_op, ctx.group), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, op, group):
        ctx.dim, ctx.group = dim, group
        return _scatter(x.detach(), dim, op, group)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.dim, ctx.group), None, None, None


def _a2a(x, group):
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _a2a(x.detach(), group)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, ctx.group), None


def _permute(x, perm, group):
    rank = group_rank(group)
    out = torch.zeros_like(x, memory_format=torch.contiguous_format)
    x = x.contiguous()
    ops = []
    for src, dst in perm:
        if src == rank:
            ops.append(dist.P2POp(dist.isend, x,
                                  dist.get_global_rank(group, dst), group))
        if dst == rank:
            ops.append(dist.P2POp(dist.irecv, out,
                                  dist.get_global_rank(group, src), group))
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    return out


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, perm, group):
        ctx.perm, ctx.group = perm, group
        return _permute(x.detach(), perm, group)

    @staticmethod
    def backward(ctx, g):
        return _permute(g, [(d, s) for s, d in ctx.perm], ctx.group), \
            None, None


def all_reduce(x, op='sum', group=None):
    """The all_reduce of x over `group` ('sum', 'avg', 'max' or 'min');
    'sum' and 'avg' carry a gradient (the same all_reduce)."""
    if op in ('sum', 'avg'):
        return _AllReduce.apply(x, op, group)
    if x.requires_grad:
        raise NotImplementedError(
            'all_reduce(op=%r) has no gradient: gather the values and '
            'reduce them instead' % (op,))
    return _reduce_(x.detach().clone(
        memory_format=torch.contiguous_format), op, group)


def all_gather(x, dim=0, group=None, grad_op='sum'):
    """The ranks' x concatenated along `dim`, in rank order."""
    return _AllGather.apply(x, dim, grad_op, group)


def reduce_scatter(x, dim=0, op='sum', group=None):
    """This rank's block along `dim` of the sum ('avg': mean) of x over
    the ranks."""
    return _ReduceScatter.apply(x, dim, op, group)


def all_to_all(x, group=None):
    """Block j of dim 0 of x goes to rank j; block i of the result came
    from rank i."""
    return _AllToAll.apply(x, group)


def ppermute(x, perm, group=None):
    """Rank src sends x to rank dst for each (src, dst) of perm; a rank
    nothing is sent to receives zeros (jax.lax.ppermute's rule)."""
    return _Permute.apply(x, tuple((int(s), int(d)) for s, d in perm), group)
