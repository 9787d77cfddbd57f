"""The collectives of the ``data`` axis, for both placements of its ranks.

The reference's data-parallel collectives are ``lax.pmean``,
``lax.psum_scatter(tiled=True) / k`` and ``lax.all_gather(tiled=True)``
over a mesh axis (``parallel/zero.py``, ``parallel/trainer.py``).  The
port has two placements of K ranks (``parallel/mesh.py``), behind one
interface: every method takes a sequence with one entry per rank THIS
process holds (``local_ranks``), and returns one entry per such rank.

- :class:`InProcessComm`: all K ranks in this process, run in turn on
  one device.  The mean is a sum over the stacked per-rank tensors
  divided by K; the reduce-scatter is that mean over the stacked
  ``(K, padded)`` flat gradients, viewed as K contiguous shards; the
  all-gather is the concatenation of the shards into the flat vector.
- :class:`ProcessGroupComm`: one rank per process over the default
  ``torch.distributed`` group (NCCL on cards, gloo on the CPU):
  ``all_reduce``, ``reduce_scatter_tensor`` and
  ``all_gather_into_tensor``.

A mesh picks its placement when it is built (``Mesh.comm``); nothing
swaps one for the other.
"""
from __future__ import annotations

import torch

__all__ = ["InProcessComm", "ProcessGroupComm"]


class InProcessComm:
    """K ranks in this process, in turn on ``device``."""

    placement = "in_process"

    def __init__(self, k, device):
        self.k = int(k)
        self.device = device
        self.local_ranks = list(range(self.k))

    def _stack(self, per_rank):
        if isinstance(per_rank, torch.Tensor):
            return per_rank
        return torch.stack(list(per_rank))

    def mean(self, per_rank):
        """``pmean``: one tensor, the sum over ranks divided by K."""
        return self._stack(per_rank).sum(0).div_(self.k)

    def min(self, per_rank):
        """``pmin`` over ranks."""
        return self._stack(per_rank).amin(0)

    def reduce_scatter_mean(self, rows):
        """``psum_scatter(tiled=True) / k``: ``rows`` are the K ranks'
        ``(padded,)`` flat vectors (or their ``(K, padded)`` stack);
        returns rank r's ``(padded / K,)`` shard of the mean, for each r
        (views of one buffer)."""
        flat = self.mean(rows)
        return list(flat.view(self.k, -1).unbind(0))

    def all_gather(self, shards, out):
        """``all_gather(tiled=True)`` into ``out`` (``(padded,)``): rank
        r's shard lands at ``[r * shard, (r + 1) * shard)``; a shard that
        is already that view of ``out`` is not copied."""
        dst = out.view(self.k, -1)
        for r, s in enumerate(shards):
            if s.data_ptr() != dst[r].data_ptr() or s.dtype != dst.dtype:
                dst[r].copy_(s)
        return out


class ProcessGroupComm:
    """One rank per process over the default process group."""

    placement = "process_group"

    def __init__(self, k, device):
        import torch.distributed as dist
        self._dist = dist
        self.k = int(k)
        if self.k != dist.get_world_size():
            raise ValueError("a process-group data axis spans the world: "
                             "%d ranks against world size %d"
                             % (self.k, dist.get_world_size()))
        self.device = device
        self.rank = dist.get_rank()
        self.local_ranks = [self.rank]

    def mean(self, per_rank):
        (t,) = per_rank
        t = t.clone()
        self._dist.all_reduce(t, op=self._dist.ReduceOp.SUM)
        return t.div_(self.k)

    def min(self, per_rank):
        (t,) = per_rank
        t = t.clone()
        self._dist.all_reduce(t, op=self._dist.ReduceOp.MIN)
        return t

    def reduce_scatter_mean(self, rows):
        (flat,) = rows
        out = torch.empty(flat.numel() // self.k, dtype=flat.dtype,
                          device=flat.device)
        self._dist.reduce_scatter_tensor(out, flat.contiguous(),
                                         op=self._dist.ReduceOp.SUM)
        return [out.div_(self.k)]

    def all_gather(self, shards, out):
        (s,) = shards
        self._dist.all_gather_into_tensor(out, s.to(out.dtype).clone())
        return out
