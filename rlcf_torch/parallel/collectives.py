"""The collectives of the sharded paths, with the gradients JAX's give.

Under tp every rank computes the same replicated loss from features or
scores gathered over the class or gallery axis. So the gather's backward
takes this rank's slice of the incoming gradient as it is: that gradient is
already the whole loss's, on every rank. (``torch.distributed.nn``'s
all_gather sums the incoming gradients over the ranks, which makes the
gradient tp times too large here.) What each rank then holds for a
replicated input of its shard (the prompt context, a query's features) is
its share of the gradient; the psum over tp (``all_reduce_grads``, or
``reduce_grad`` on the way back) makes it the whole gradient, as
``shard_map`` + psum does in JAX (``rlcf_tpu/parallel/tp_prompt.py``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

# A group of None (an axis of size 1: ``make_mesh`` makes no group for it)
# runs no collective; any group given runs one, a group of one rank too.


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.dim, ctx.rows = dim, x.shape[dim]
        ctx.index = dist.get_rank(group)
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.index * ctx.rows, ctx.rows).contiguous(), None, None


def gather_replicated(x, group, dim: int = 0):
    """Every rank's ``x`` (equal shapes) concatenated along ``dim`` in rank
    order, on every rank. Its backward returns this rank's slice of the
    incoming gradient, with no sum over the ranks: the downstream loss is
    replicated, so every rank's incoming gradient is already the whole one."""
    if group is None:
        return x
    return _GatherReplicated.apply(x, group, dim)


class _ReduceGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def reduce_grad(x, group):
    """``x`` unchanged; on the way back its gradient is summed over
    ``group``. Put it on a replicated tensor whose consumers are sharded
    (Megatron's ``f``): the gradient of everything before it is then whole."""
    if group is None:
        return x
    return _ReduceGrad.apply(x, group)


def all_reduce_grads(grads, group):
    """The psum over ``group`` of a replicated trainable's gradients (a list
    of tensors, or a tensor), in place and in one collective per dtype;
    returns them. Run it before the optimizer step."""
    single = torch.is_tensor(grads)
    leaves = [grads] if single else list(grads)
    if group is not None:
        by_dtype = {}
        for g in leaves:
            by_dtype.setdefault(g.dtype, []).append(g)
        for same in by_dtype.values():
            flat = torch.cat([g.reshape(-1) for g in same])
            dist.all_reduce(flat, group=group)
            for g, part in zip(same, flat.split([g.numel() for g in same])):
                g.copy_(part.view_as(g))
    return grads


def all_reduce_sum(x, group):
    """The sum of ``x`` over ``group`` on every rank (out of place; no
    gradient): the row-parallel products' partial sums."""
    if group is None:
        return x
    x = x.contiguous().clone()
    dist.all_reduce(x, group=group)
    return x


def max_over(n: int, group, device=None) -> int:
    """The largest of the ranks' ``n`` over ``group``, on every rank."""
    if group is None:
        return n
    x = torch.tensor([n], device=device)
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return int(x.item())


def gather_objects(items: list, group) -> list:
    """Every rank's list concatenated in rank order, on every rank."""
    if group is None:
        return items
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, items, group=group)
    return [x for part in out for x in part]
