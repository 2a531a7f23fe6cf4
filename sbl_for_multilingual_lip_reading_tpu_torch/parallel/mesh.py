"""Data and tensor parallelism of the port (the ('data', 'model') mesh of
the JAX package's ``parallel/mesh.py``).

JAX shards each batch over a ('data', 'model') mesh of one program and lets
GSPMD insert the collectives.  Here each process of a data x model grid
drives one card (``torch.distributed``: NCCL between cards, gloo on the CPU
or for processes sharing a card).  Process rank r sits at data index
r // model and model index r % model (JAX's ``create_device_mesh((data,
model))`` order) and joins two groups: its data group (the processes of its
model index) and its model group (those of its data index).

Data axis.  Each data index takes its stripe of every global batch (the
batch size stays global, as in JAX); a step then equals the one-process
step on the stripes put one after another:

* the loss is the whole batch's mean: each process scales its own by
  W * n_local / n_global (``n`` the non-pad tokens or valid samples, summed
  over the data group), and the gradients are averaged over the data group
  after the backward, before the clip and Adam;
* BatchNorm statistics are the whole batch's (``sync_batchnorm``, JAX's
  default): each BN sums (sum x, sum x^2) over the data group, and in the
  backward the kernel route sums K8's (sum dy, sum dy * xhat);
  ``set_sync_batchnorm(model, None)`` keeps them per process, the
  reference's ``nn.DataParallel``, with data index 0's running statistics
  broadcast after every step;
* dropout draws the masks of the process's rows of the whole batch
  (``models.layers.DropoutRNG`` with ``BatchRows``), and the seeds and
  teacher-forcing coins are the same in every process.

The step issues its collectives (the gradient all-reduce, the loss's
counts, the BatchNorm sums, the running statistics' broadcast) on the
current stream with no host read, so under NCCL the whole step can be
captured as a CUDA graph (``training.steps.GraphedStep``; ``graphable``);
gloo's collectives run on the host and cannot, so a gloo grid runs the
epoch-fused step eagerly.  The epoch-fused route's device cache holds only
the data index's block of the dataset (``data_index``).

Model axis (tensor parallelism, Megatron's layout of JAX's ``PARAM_RULES``).
``shard_model`` cuts a model built whole from the seed down to the
process's slice: the attention projections ``w_qs``/``w_ks``/``w_vs`` and
the FFN's ``w_1`` column-parallel (their output rows, and biases), the
attention's ``fc`` and the FFN's ``w_2`` row-parallel (their input
columns); everything else (convs, BN, LN, embeddings, the output heads)
stays whole in every process.  Each decision is JAX's ``param_spec`` on
the parameter's JAX path: a dimension that does not divide by the model
size falls back to replication, and an ``fc`` the rules do not name (the
unidirectional decoder's) stays whole, its input heads gathered first.
One decision is the port's own: an attention whose heads do not divide by
the model size stays whole, where JAX would split a head's columns across
devices (n_head * d_k divides and n_head does not); the values are the
same either way.  The processes of a model group see the same batch and
compute the same values as the unsharded model.  Their replicated
parameters' gradients agree up to the last bits of kernels that are not
deterministic (cuDNN's backward), and are averaged over the model group so
that the replicated weights stay equal.  The global gradient norm counts a
sharded parameter's squares summed over the group and a replicated one
once (``training.schedule.clip_by_global_norm_``).  ``shard_state_dict`` /
``gather_state_dict`` convert between the whole state dict and the
process's slices (checkpoints are written whole, so they load at any
model size; the Adam moments follow their parameters).
"""
from __future__ import annotations

import dataclasses
import os
import re
from typing import Dict, Iterable, List, Optional, Tuple

import torch
import torch.distributed as dist

from ..ops.attention import BatchRows
from ..utils.device import resolve_device
from .tensor import gather_from_model

# JAX's PARAM_RULES on JAX's paths: the first match decides; "column" shards
# the kernel's output dim, "row" its input dim (aligned to the TRAILING dims,
# so the SBL decoder's (2, ...) direction axis stays whole)
PARAM_RULES: Tuple[Tuple[str, str], ...] = (
    (r".*(w_qs|w_ks|w_vs)/kernel$", "column"),
    (r".*(slf_attn|enc_attn|slf|cross)/fc/kernel$", "row"),
    (r".*(pos_ffn|ffn)/w_1/kernel$", "column"),
    (r".*(pos_ffn|ffn)/w_2/kernel$", "row"),
)


@dataclasses.dataclass
class DataMesh:
    """One process's place in the (data, model) grid: its data index
    (``rank``) among ``size`` data indices, its model index
    (``model_rank``) among ``model_size``, its device, the backend, and its
    two process groups (None: the whole world, where it is the group)."""
    rank: int
    size: int
    device: torch.device
    backend: str
    model_rank: int = 0
    model_size: int = 1
    data_group: Optional[object] = None
    model_group: Optional[object] = None

    @property
    def global_rank(self) -> int:
        return self.rank * self.model_size + self.model_rank

    @property
    def data_index(self) -> int:
        """The process's data index (``rank``): which block of the dataset
        the epoch-fused route's device cache holds."""
        return self.rank

    @property
    def graphable(self) -> bool:
        """Whether the step's collectives can be captured in a CUDA graph:
        NCCL's can (issued on the capturing stream), gloo's cannot."""
        return self.backend == "nccl"

    def rows(self, local_batch: int) -> BatchRows:
        """This process's rows of the global batch."""
        return BatchRows(self.rank * local_batch, local_batch,
                         local_batch * self.size)

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` in place over the data group."""
        dist.all_reduce(t, group=self.data_group)
        return t

    def all_reduce_grads_(self, params: Iterable[torch.nn.Parameter]) -> None:
        """Average the gradients of ``params`` over the data group, in one
        collective (every process of it has gradients on the same
        parameters, of the same shapes).  Under tensor parallelism the
        replicated parameters' gradients are first averaged over the model
        group: each process computes the same value, but not bit for bit
        (cuDNN's backward is not deterministic), and replicated weights
        must stay equal in every process."""
        params = [p for p in params if p.grad is not None]
        if self.model_size > 1:
            _mean_([p.grad for p in params
                    if getattr(p, "tp_mesh", None) is None],
                   self.model_group, self.model_size)
        if self.size > 1:
            _mean_([p.grad for p in params], self.data_group, self.size)

    def broadcast_(self, tensors: List[torch.Tensor]) -> None:
        """Overwrite ``tensors`` with data index 0's (of this model index),
        in one collective a dtype."""
        by_dtype = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        src = (0 if self.data_group is None
               else dist.get_global_rank(self.data_group, 0))
        for group in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in group])
            dist.broadcast(flat, src=src, group=self.data_group)
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


def _mean_(tensors: List[torch.Tensor], group, n: int) -> None:
    """Average ``tensors`` in place over the ``n`` processes of ``group``,
    in one collective."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat /= n
    torch._foreach_copy_(tensors, [f.view_as(t) for f, t in zip(
        torch.split(flat, [t.numel() for t in tensors]), tensors)])


def grid_groups(data: int, model: int) -> Tuple[List[List[int]], List[List[int]]]:
    """The global ranks of every data group (one per model index) and every
    model group (one per data index) of a data x model grid."""
    return ([[d * model + m for d in range(data)] for m in range(model)],
            [[d * model + m for m in range(model)] for d in range(data)])


def make_mesh(data: int = 1, model: int = 1, device=None,
              rank: Optional[int] = None, init_method: Optional[str] = None,
              backend: Optional[str] = None) -> DataMesh:
    """Join (starting it where needed) the process group of data x model
    processes and return this process's ``DataMesh``.

    rank (the global one) and init_method default to torchrun's
    environment (RANK, MASTER_ADDR/MASTER_PORT).  The device defaults to
    card LOCAL_RANK (else card ``rank``); ``device="cpu"`` runs on the CPU.
    The backend is NCCL on cards and gloo on the CPU; NCCL needs a card per
    process, and asking for more processes than there are cards raises, as
    JAX's ``make_mesh`` does.  ``backend="gloo"`` with CUDA devices lets
    processes share a card (one process per card is still the norm)."""
    world = data * model
    if rank is None:
        rank = int(os.environ.get("RANK", 0))
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a mesh of {world} processes")
    if device is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
    device = resolve_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        cards = torch.cuda.device_count()
        if backend == "nccl" and world > cards:
            raise ValueError(f"need {world} devices, have {cards}")
        torch.cuda.set_device(device)
    if dist.is_initialized():
        if dist.get_world_size() != world or dist.get_rank() != rank:
            raise ValueError(
                f"the process group is rank {dist.get_rank()} of "
                f"{dist.get_world_size()}, not rank {rank} of {world}")
    else:
        kw = {}
        if backend == "nccl":
            kw["device_id"] = device
        dist.init_process_group(backend, init_method=init_method or "env://",
                                world_size=world, rank=rank, **kw)
    d, m = divmod(rank, model)
    data_group = model_group = None
    if model > 1:
        # every process creates every group, in the same order
        data_ranks, model_ranks = grid_groups(data, model)
        data_groups = [dist.new_group(r) for r in data_ranks]
        model_groups = [dist.new_group(r) for r in model_ranks]
        data_group, model_group = data_groups[m], model_groups[d]
    return DataMesh(d, data, device, backend, m, model, data_group,
                    model_group)


# ---------------------------------------------------------------------------
# the model axis: which parameters shard, and the state dicts
# ---------------------------------------------------------------------------

def _jax_path(name: str) -> str:
    """The JAX variable path of a port parameter name (the port names its
    modules after JAX's; a Dense ``weight`` is JAX's ``kernel``)."""
    *mods, leaf = name.split(".")
    return "/".join(mods + ["kernel" if leaf == "weight" else leaf])


def param_spec(name: str, shape, model: int) -> Optional[int]:
    """JAX's ``param_spec`` decision for a port parameter: the port dim it
    shards over the model axis, or None (replicated).  A Dense weight is
    (..., out, in) here and (..., in, out) in JAX: a column rule shards
    dim -2, a row rule dim -1, and each falls back to replication when that
    dim does not divide by ``model``."""
    path = _jax_path(name)
    for pattern, kind in PARAM_RULES:
        if re.match(pattern, path):
            if len(shape) < 2 or model <= 1:
                return None
            dim = len(shape) - (2 if kind == "column" else 1)
            return dim if shape[dim] % model == 0 else None
    return None


def shard_plan(model: torch.nn.Module, model_size: int
               ) -> Dict[str, Tuple[int, Tuple[int, ...]]]:
    """{parameter name: (the dim it shards, its whole shape)} for the whole
    (unsharded) ``model`` at ``model_size``.  A module (an attention, its
    cross K/V, an FFN) shards when each of its column-parallel projections
    has a ``param_spec`` and, for an attention, its heads divide by the
    model size; its row-parallel layer then shards where its own
    ``param_spec`` says so.  Column-parallel biases follow their weights.
    Everything else is replicated."""
    from ..models.layers import _Sharded
    plan = {}
    if model_size <= 1:
        return plan
    for mname, mod in model.named_modules():
        if not isinstance(mod, _Sharded):
            continue
        prefix = mname + "." if mname else ""
        specs = {n: param_spec(f"{prefix}{n}.weight",
                               tuple(getattr(mod, n).weight.shape), model_size)
                 for n, _ in mod.tp_denses()}
        heads = getattr(mod, "n_head", model_size)
        if any(specs[n] is None for n in mod.COLUMN) or heads % model_size:
            continue
        for n, kind in mod.tp_denses():
            if specs[n] is None:
                continue
            dense = getattr(mod, n)
            plan[f"{prefix}{n}.weight"] = (specs[n], tuple(dense.weight.shape))
            if kind == "column" and dense.bias is not None:
                plan[f"{prefix}{n}.bias"] = (dense.bias.dim() - 1,
                                             tuple(dense.bias.shape))
    return plan


def shard_model(model: torch.nn.Module, mesh: DataMesh) -> torch.nn.Module:
    """Cut ``model`` (built whole, the same in every process) down to this
    process's slice over ``mesh``'s model group, in place; record the plan
    and the mesh as ``model.tp_plan`` (empty at model size 1) and
    ``model.tp_mesh``.  An SBL decoder that
    runs K11 (``use_fused_decoder_layer``) is marked to run whole in eval,
    on weights gathered once a batch: the kernel takes the whole layer, as
    GSPMD runs a custom call it cannot partition."""
    from ..models.decoder_sbl import SBLDecoder
    from ..models.layers import _Sharded
    plan = shard_plan(model, mesh.model_size)
    for mname, mod in model.named_modules():
        prefix = mname + "." if mname else ""
        if isinstance(mod, _Sharded):
            kinds = [(n, k) for n, k in mod.tp_denses()
                     if f"{prefix}{n}.weight" in plan]
            if kinds:
                mod.shard_(mesh, kinds)
    for dec in model.modules():
        if isinstance(dec, SBLDecoder) and dec.use_fused_layer:
            for mod in dec.modules():
                if isinstance(mod, _Sharded) and mod.mesh is not None:
                    mod.whole_in_eval = True
    model.tp_plan, model.tp_mesh = plan, mesh
    return model


def _plan(model):
    """(plan, mesh) of a model ``shard_model`` sharded; ({}, None) else."""
    plan = getattr(model, "tp_plan", None) or {}
    return plan, getattr(model, "tp_mesh", None) if plan else None


def shard_state_dict(sd: Dict[str, torch.Tensor], model: torch.nn.Module
                     ) -> Dict[str, torch.Tensor]:
    """The slices of a whole state dict that this process of ``model``
    (sharded by ``shard_model``) holds; entries the plan does not name, or
    whose shape is not the whole one, are left as they are."""
    plan, mesh = _plan(model)
    if not plan:
        return dict(sd)
    out = {}
    for k, v in sd.items():
        p = plan.get(k)
        if p is not None and tuple(v.shape) == p[1]:
            v = v.chunk(mesh.model_size, p[0])[mesh.model_rank].contiguous()
        out[k] = v
    return out


def gather_state_dict(sd: Dict[str, torch.Tensor], model: torch.nn.Module
                      ) -> Dict[str, torch.Tensor]:
    """The whole state dict of a sharded ``model`` from this process's
    ``sd`` (its ``state_dict()``): every process of the model group calls
    it, in the same order."""
    plan, mesh = _plan(model)
    if not plan:
        return dict(sd)
    return {k: gather_from_model(v, mesh, plan[k][0]) if k in plan else v
            for k, v in sd.items()}


def _map_moments(opt_sd: Dict, model: torch.nn.Module, fn) -> Dict:
    """The optimizer state dict with ``fn(name, tensor)`` applied to each
    parameter-shaped moment (Adam's ``exp_avg``/``exp_avg_sq``); optimizer
    index i is the model's i-th parameter, as ``make_optimizer`` takes
    ``model.parameters()``."""
    names = [n for n, _ in model.named_parameters()]
    state = {}
    for i, st in opt_sd["state"].items():
        state[i] = {k: fn(names[int(i)], v) if torch.is_tensor(v) and v.dim() > 0
                    else v for k, v in st.items()}
    return {**opt_sd, "state": state}


def gather_optimizer_state(opt_sd: Dict, model: torch.nn.Module) -> Dict:
    """The optimizer state with every sharded parameter's moments whole
    (``shard_opt_state``'s inverse); a collective of the model group."""
    plan, mesh = _plan(model)
    if not plan:
        return opt_sd
    return _map_moments(opt_sd, model, lambda n, v: gather_from_model(
        v, mesh, plan[n][0]) if n in plan else v)


def shard_optimizer_state(opt_sd: Dict, model: torch.nn.Module) -> Dict:
    """JAX ``shard_opt_state``: each moment takes its parameter's slice."""
    plan, mesh = _plan(model)
    if not plan:
        return opt_sd
    return _map_moments(opt_sd, model, lambda n, v: v.chunk(
        mesh.model_size, plan[n][0])[mesh.model_rank].contiguous()
        if n in plan and tuple(v.shape) == plan[n][1] else v)


def set_sync_batchnorm(model: torch.nn.Module, mesh: Optional[DataMesh]) -> None:
    """Take every BatchNorm's train-mode statistics over the data group of
    ``mesh`` (None: per process); the model group sees the same batch."""
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
