"""Data parallelism of the port (the data axis of the JAX package's
``parallel/mesh.py``).

JAX shards each batch over a ('data', 'model') mesh of one program and lets
GSPMD insert the collectives.  Here ``data`` processes each drive one card
(``torch.distributed``: NCCL between cards, gloo on the CPU) and hold the
whole model.  Each takes its stripe of every global batch (the batch size
stays global, as in JAX); a step then equals the one-process step on the
processes' batches put one after another:

* the loss is the whole batch's mean: each process scales its own by
  W * n_local / n_global (``n`` the non-pad tokens or valid samples, summed
  over the processes), and the gradients are averaged over them after the
  backward, before the clip and Adam;
* BatchNorm statistics are the whole batch's (``sync_batchnorm``, JAX's
  default): each BN sums (sum x, sum x^2) over the processes, and in the
  backward the kernel route sums K8's (sum dy, sum dy * xhat);
  ``set_sync_batchnorm(model, None)`` keeps them per process, the
  reference's ``nn.DataParallel``, with process 0's running statistics
  broadcast after every step;
* dropout draws the masks of the process's rows of the whole batch
  (``models.layers.DropoutRNG`` with ``BatchRows``), and the seeds and
  teacher-forcing coins are the same in every process.

The model axis (tensor parallelism, JAX ``PARAM_RULES``) is not ported.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Iterable, List, Optional

import torch
import torch.distributed as dist

from ..ops.attention import BatchRows
from ..utils.device import resolve_device

TENSOR_PARALLEL = "ROADMAP.md queue A item 17 (tensor parallelism)"


@dataclasses.dataclass
class DataMesh:
    """One process's view of the data-parallel group: its rank, the number
    of processes (``size``), its device and the backend."""
    rank: int
    size: int
    device: torch.device
    backend: str

    def rows(self, local_batch: int) -> BatchRows:
        """This process's rows of the global batch."""
        return BatchRows(self.rank * local_batch, local_batch,
                         local_batch * self.size)

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` in place over the processes."""
        dist.all_reduce(t)
        return t

    def all_reduce_grads_(self, params: Iterable[torch.nn.Parameter]) -> None:
        """Average the gradients of ``params`` over the processes, in one
        collective (every process has gradients on the same parameters)."""
        grads = [p.grad for p in params if p.grad is not None]
        if not grads:
            return
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat)
        flat /= self.size
        torch._foreach_copy_(grads, [f.view_as(g) for f, g in zip(
            torch.split(flat, [g.numel() for g in grads]), grads)])

    def broadcast_(self, tensors: List[torch.Tensor]) -> None:
        """Overwrite ``tensors`` with process 0's, in one collective a
        dtype."""
        by_dtype = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for group in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in group])
            dist.broadcast(flat, src=0)
            torch._foreach_copy_(group, [f.view_as(t) for f, t in zip(
                torch.split(flat, [t.numel() for t in group]), group)])

    def broadcast_object(self, obj):
        """Process 0's ``obj`` (a picklable value) in every process."""
        box = [obj]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    def barrier(self) -> None:
        if self.backend == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()


def make_mesh(data: int = 1, model: int = 1, device=None,
              rank: Optional[int] = None, init_method: Optional[str] = None,
              backend: Optional[str] = None) -> DataMesh:
    """Join (starting it where needed) the process group of ``data``
    processes and return this process's ``DataMesh``.

    rank and init_method default to torchrun's environment (RANK,
    MASTER_ADDR/MASTER_PORT).  The device defaults to card LOCAL_RANK (else
    card ``rank``); ``device="cpu"`` runs on the CPU.  The backend is NCCL
    on cards and gloo on the CPU; NCCL needs a card per process, and asking
    for more processes than there are cards raises, as JAX's ``make_mesh``
    does.  ``backend="gloo"`` with CUDA devices lets processes share a card
    (one process per card is still the norm).  ``model`` > 1 raises:
    tensor parallelism is not ported."""
    if model > 1:
        raise NotImplementedError(f"--mesh-model > 1 is not ported yet: "
                                  f"{TENSOR_PARALLEL}")
    if rank is None:
        rank = int(os.environ.get("RANK", 0))
    if not 0 <= rank < data:
        raise ValueError(f"rank {rank} outside a mesh of {data} processes")
    if device is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
    device = resolve_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        cards = torch.cuda.device_count()
        if backend == "nccl" and data > cards:
            raise ValueError(f"need {data} devices, have {cards}")
        torch.cuda.set_device(device)
    if dist.is_initialized():
        if dist.get_world_size() != data or dist.get_rank() != rank:
            raise ValueError(
                f"the process group is rank {dist.get_rank()} of "
                f"{dist.get_world_size()}, not rank {rank} of {data}")
    else:
        kw = {}
        if backend == "nccl":
            kw["device_id"] = device
        dist.init_process_group(backend, init_method=init_method or "env://",
                                world_size=data, rank=rank, **kw)
    return DataMesh(rank, data, device, backend)


def set_sync_batchnorm(model: torch.nn.Module, mesh: Optional[DataMesh]) -> None:
    """Take every BatchNorm's train-mode statistics over the processes of
    ``mesh`` (None: per process)."""
    from ..models.frontend import BatchNorm
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.sync = mesh


def running_stats(model: torch.nn.Module) -> List[torch.Tensor]:
    """The BatchNorm running statistics of ``model``."""
    from ..models.frontend import BatchNorm
    return [t for m in model.modules() if isinstance(m, BatchNorm)
            for t in (m.running_mean, m.running_var)]


def shutdown() -> None:
    """Leave the process group, where one was started."""
    if dist.is_initialized():
        dist.destroy_process_group()
