"""BAD: torch.distributed collectives on rank-dependent paths — the ranks
that skip the call leave the others waiting in it forever."""
import torch.distributed as dist


def guarded_branch(x):
    if dist.get_rank() == 0:
        dist.all_reduce(x)             # only rank 0 arrives
    return x


def early_exit(x):
    rank = dist.get_rank()
    if rank != 0:
        return x
    dist.barrier()                     # the others already returned
    return x


def rank_trip_count(x):
    for _ in range(dist.get_rank()):
        dist.broadcast(x, src=0)       # each rank a different count
    return x
