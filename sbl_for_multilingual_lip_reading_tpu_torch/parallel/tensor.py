"""Megatron's two operators, and the gather of a sharded tensor, over the
model group of a ``parallel.DataMesh`` (tensor parallelism).

* f, ``copy_to_model``: before a column-parallel block.  The identity; its
  backward sums the input's gradient over the model group (each process's
  heads or FFN columns contribute a part of it).
* g, ``reduce_from_model``: after a row-parallel product.  Its forward sums
  the partial products over the model group; its backward is the
  identity (the sum is the same in every process, and so is its gradient).

Both sum in f32: gloo's bfloat16 support is not relied on, and one
rounding after the sum is closest to the unsharded product's.

``gather_heads`` joins a column-parallel output whole (along its last dim)
for a layer that runs whole; its backward keeps the process's slice of the
gradient, which is the same whole gradient in every process.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _sum_f32(t: torch.Tensor, mesh) -> torch.Tensor:
    out = t.to(torch.float32, copy=True)
    dist.all_reduce(out, group=mesh.model_group)
    return out


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_f32(g, ctx.mesh).to(g.dtype), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return _sum_f32(x, mesh).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return gather_from_model(x, mesh, -1)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        return g.chunk(mesh.model_size, -1)[mesh.model_rank].contiguous(), None


def copy_to_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """f: ``x``, with its gradient summed over ``mesh``'s model group."""
    return _CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """g: the sum of ``x`` over ``mesh``'s model group (in f32), with the
    identity backward."""
    return _ReduceFromModel.apply(x, mesh)


def gather_heads(x: torch.Tensor, mesh) -> torch.Tensor:
    """The whole (..., n) tensor whose (..., n / M) slices the processes of
    ``mesh``'s model group hold, with the slicing backward."""
    return _GatherHeads.apply(x, mesh)


@torch.no_grad()
def gather_from_model(t: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """The whole tensor whose slices along ``dim`` the processes of
    ``mesh``'s model group hold, in model-index order (no gradient)."""
    t = t.detach().contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.model_size)]
    dist.all_gather(parts, t, group=mesh.model_group)
    return torch.cat(parts, dim=dim)
