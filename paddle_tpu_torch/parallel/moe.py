"""Expert parallelism: top-k gated mixture-of-experts with all_to_all
dispatch over a mesh axis.

Parity: the JAX package's parallel/moe.py (:36-181). Tokens are gated top-k
(k=1 Switch-style raw-probability gates; k>1 GShard-style gates
renormalized over the selected experts), packed into fixed per-expert
capacity slots (overflow tokens are dropped, all first choices claiming
slots before any second choice), sent to their expert with ONE all_to_all,
transformed, and returned with a second all_to_all; dropped tokens pass
through gate-weighted as zeros.

The port runs one process per rank: `moe_apply` takes this rank's tokens
and the FULL stacked expert weights, and runs the experts of this rank's
block. Expert e lives on rank e // epd at local index e % epd (epd: experts
per rank), as in the JAX :149-168. The expert function runs once per local
expert through torch.func.vmap, as jax.vmap runs it there: a batched
product over [epd, tokens, d].

`load_balancing_loss` is the Switch/GShard auxiliary objective
E * sum_e f_e * P_e, differentiable through P_e, minimized at 1.0 by a
uniform router.
"""
import torch

from . import _comm

__all__ = ['moe_apply', 'stack_expert_params', 'router_topk', 'pack_topk',
           'combine_topk', 'pack_top1', 'combine_top1',
           'load_balancing_loss']


def _tree_map(fn, *trees):
    t0 = trees[0]
    if isinstance(t0, dict):
        return type(t0)((k, _tree_map(fn, *[t[k] for t in trees]))
                        for k in t0)
    if isinstance(t0, (list, tuple)):
        return type(t0)(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def stack_expert_params(per_expert_params):
    """[{param tree} per expert] -> one tree with a leading expert axis."""
    return _tree_map(lambda *xs: torch.stack([torch.as_tensor(x)
                                              for x in xs]),
                     *per_expert_params)


def _topk_idx(logits, top_k):
    """lax.top_k's indices: the largest first, a tie to the lower index (a
    stable descending sort)."""
    return torch.sort(logits, dim=-1, descending=True,
                      stable=True).indices[..., :top_k]


def router_topk(logits, top_k):
    """Routing decisions shared by the dense and sharded paths (the JAX
    :36): (expert [k, nt] int64, gate [k, nt] fp32). k=1 keeps the Switch
    gate (the chosen expert's raw softmax probability); k>1 renormalizes
    the selected probabilities to sum to 1 per token (GShard)."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)      # [nt, E]
    idx = _topk_idx(logits, top_k)                               # [nt, k]
    gate = torch.take_along_dim(probs, idx, dim=-1)              # [nt, k]
    if top_k > 1:
        gate = gate / gate.sum(dim=-1, keepdim=True)
    return idx.t(), gate.t()


def load_balancing_loss(logits, top_k=1):
    """E * sum_e f_e * P_e (the JAX :52): f_e the fraction of (token,
    choice) assignments routed to expert e, P_e the mean router
    probability of e; the gradient flows through P_e."""
    n_exp = logits.shape[-1]
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    idx = _topk_idx(logits, top_k)
    f = torch.nn.functional.one_hot(idx, n_exp).to(torch.float32).mean(
        dim=(0, 1))
    p = probs.mean(dim=0)
    return n_exp * (f * p).sum()


def pack_topk(xs, logits, n_exp, cap, top_k=1):
    """Top-k routing and fixed-capacity packing (the JAX :67), shared by the
    sharded path below and the dense rule (ops_impl/moe_ops.py), so the two
    stay identical. Slots are claimed choice-major (every token's first
    choice before any second choice), then in token order.

    Returns (send [n_exp, cap, d], route): route is (expert, slot, keep,
    gate), each [k, nt]."""
    nt, d = xs.shape
    expert, gate = router_topk(logits, top_k)                   # [k, nt]
    onehot = torch.nn.functional.one_hot(expert.reshape(-1), n_exp)
    pos = torch.cumsum(onehot, dim=0) * onehot                  # 1-based
    slot = (pos.sum(dim=-1) - 1).reshape(top_k, nt)             # [k, nt]
    keep = slot < cap
    # a dropped assignment lands in a spare row past the buffer, which is
    # cut off (the JAX scatter adds zeros at (0, 0) instead: the same)
    flat = torch.where(keep, expert * cap + slot,
                       torch.full_like(slot, n_exp * cap)).reshape(-1)
    xs_k = xs.unsqueeze(0).expand(top_k, nt, d).reshape(-1, d)
    # each kept row is added once to zeros (no host sync on the card, so a
    # captured step holds it)
    send = xs.new_zeros((n_exp * cap + 1, d)).index_add(0, flat, xs_k)
    return send[:n_exp * cap].reshape(n_exp, cap, d), \
        (expert, slot, keep, gate)


def combine_topk(back, route, dtype):
    """Unpack expert outputs [n_exp, cap, d_out] by route, gate-weight and
    sum over the k choices; dropped assignments contribute zeros."""
    expert, slot, keep, gate = route                            # [k, nt]
    n_exp, cap, d_out = back.shape
    flat = torch.where(keep, expert * cap + slot, torch.zeros_like(slot))
    y = back.reshape(n_exp * cap, d_out).index_select(
        0, flat.reshape(-1)).reshape(flat.shape + (d_out,))
    y = torch.where(keep.unsqueeze(-1), y, torch.zeros_like(y))
    return (y.to(torch.float32) * gate.unsqueeze(-1)).sum(dim=0).to(dtype)


def pack_top1(xs, logits, n_exp, cap):
    """Top-1 convenience wrapper (route arrays squeezed to [nt])."""
    send, (expert, slot, keep, gate) = pack_topk(xs, logits, n_exp, cap, 1)
    return send, (expert[0], slot[0], keep[0], gate[0])


def combine_top1(back, route, dtype):
    expert, slot, keep, gate = route
    return combine_topk(back, (expert[None], slot[None], keep[None],
                               gate[None]), dtype)


def _n_experts_of(stacked, ws, axis):
    leaves = _leaves(stacked)
    n_exp = leaves[0].shape[0]
    for leaf in leaves:
        if leaf.shape[0] != n_exp:
            raise ValueError('expert: inconsistent stacked leading dims '
                             '%d vs %d' % (leaf.shape[0], n_exp))
    if n_exp % ws or n_exp < ws:
        raise ValueError(
            'expert: stacked leading dim %d must equal mesh axis %r size %d '
            'or a multiple of it (experts-per-device)' % (n_exp, axis, ws))
    return n_exp


def moe_apply(expert_fn, stacked_params, x, gate_logits, mesh, axis='ep',
              capacity_factor=2.0, top_k=1):
    """Dispatch this rank's tokens to the experts and combine (the JAX
    :121).

    expert_fn(params, x) -> y   one expert's params and its [n, d] tokens
    stacked_params: tree of [n_experts, ...] tensors, the same on every
                    rank; this rank runs experts [rank*epd, (rank+1)*epd)
    x:           [n_tokens, d], this rank's tokens
    gate_logits: [n_tokens, n_experts], this rank's rows
    Returns this rank's [n_tokens, d_out]. The capacity counts this rank's
    tokens, so under overflow the drop pattern is per rank, as in the JAX
    mesh path."""
    ws = mesh.shape[axis]
    group = mesh.group(axis)
    n_exp = _n_experts_of(stacked_params, ws, axis)
    epd = n_exp // ws
    if gate_logits.shape[-1] != n_exp:
        raise ValueError(
            'gate_logits last dim %d must equal the stacked expert count %d'
            % (gate_logits.shape[-1], n_exp))
    nt, d = x.shape
    cap = int(max(1, capacity_factor * top_k * nt / n_exp))
    send, route = pack_topk(x, gate_logits, n_exp, cap, top_k)
    local = _tree_map(lambda p: p.narrow(0, mesh.coords[axis] * epd, epd),
                      stacked_params)
    if group is not None:
        send = _comm.all_to_all(send, group)
    # [ws, epd, cap, d]: block j came from rank j
    toks = send.reshape(ws, epd, cap, d).transpose(0, 1).reshape(
        epd, ws * cap, d)
    out = torch.func.vmap(expert_fn)(local, toks)
    d_out = out.shape[-1]
    out = out.reshape(epd, ws, cap, d_out).transpose(0, 1).reshape(
        n_exp, cap, d_out)
    if group is not None:
        out = _comm.all_to_all(out, group)
    return combine_topk(out, route, x.dtype)
