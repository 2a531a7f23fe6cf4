"""The training entry point of every workload (counterpart of the JAX
package's ``training/trainer.py``): the epoch loop, validation, the
best-model checkpoint, and ``train_steps``.

Reproduces the reference's protocols.  ``sbl`` (SBL train.py): epoch loop ->
train (dual 0.5 * (l2r + r2l) loss) -> validation on each eval set (greedy
bidirectional decode, WER and PER per direction) -> best model = the least
sum of l2r WER over the eval sets (train.py:161-175) -> checkpoint.  The
unidirectional ``lrw`` / ``lrw1000`` the same with one direction (and the
LRW project's augmentation: per-clip crops, RandomDrop, no FrameRemoval,
from ``cfg.data``).  ``classify``: word + language loss, validation by word
and language accuracy, best model = the highest sum of word accuracies.

Eval-protocol parity (test.py:185-218): predictions are truncated to
``gold_length + 1`` tokens before sos/eos/IGNORE are filtered, and WER is
computed over joined phoneme strings.

A ``Trainer`` holds one ``torch.Generator`` (the steps' dropout seeds and
teacher-forcing coins) and one ``np.random.Generator`` (the augmentation
plans), both from ``cfg.seed``, as the JAX trainer holds its PRNG key and
``np_rng``.  Batches come from ``Batcher`` -> ``attach_plans`` on a producer
thread (``background_iter``) -> ``prefetch_to_device``; or, with
``cache_on_device``, from the uint8 dataset uploaded to the card once and
gathered there by index, in the same order with the same plans.

The cached dataset has two routes, chosen as JAX chooses them.  By default
the epoch-fused route (``_train_epoch_fused``): the epoch's order, plans and
every step's random numbers are uploaded once (``_epoch_const``), and the
step gathers its batch on the device, indexed by the device step counter
(``steps.FusedStep``).  On a card (no mesh, or an NCCL one) the whole step
is captured once as a CUDA graph and replayed once a step
(``steps.GraphedStep``); on the CPU and on gloo grids, whose collectives a
graph cannot capture, the same fused step runs eagerly -- the log names
the route.  ``SBL_NO_EPOCH_FUSED=1`` (JAX's switch) selects the per-step
route (``_device_batches``), which draws the same batches, plans and random
numbers.  Under a mesh whose data size divides the batch and the dataset
(``_mesh_fused_ok``), the fused route keeps only the data index's N/W rows
of the dataset on its card and draws a permutation per data index (JAX
``_epoch_const_mesh``: a process's batch columns come from its own rows,
DistributedSampler's semantics); the per-step route keeps the whole dataset
and the stripes below.

Data and tensor parallelism (``mesh``, or ``cfg.mesh`` data x model > 1
under torchrun): one ``Trainer`` a process, each on its card, with the same
seeds.  Every process builds the whole model from the seed, then keeps its
slice over the model group (``parallel.shard_model``).  A process takes its
data index's stripe ``idx[d::W]`` of every global batch (from the
``Batcher``, or gathered from the device cache); the plans are drawn for
the global batch, its stripes put one after another, and cut to the
process's rows, so every process crops as the one-process run on that
batch would.  Global rank 0 logs and writes checkpoints (the model group
gathers the whole state for it); the processes of data index 0 evaluate
(together, over their model group), and the others take their results.
Traces are written a process each.  ``tensorboard_dir`` logs JAX's tags;
``profile_dir`` traces steps 1-3 of the first epoch.  The first train step
runs under the memory guard (``memguard.GuardedTrainStep``).
"""
from __future__ import annotations

import dataclasses
import itertools
import os
import time
from typing import Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import model_kind
from ..data.ingest import device_ingest
from ..data.pipeline import Batcher, background_iter, prefetch_to_device
from ..data.sampler import TwoStreamBatchSampler
from ..data.transforms import make_train_plans
from ..models import build_model
from ..models.layers import draw_step_random
from ..recognize import recognize_batch
from ..utils.device import resolve_device
from ..utils.logging import get_logger
from ..utils.metrics import AverageMeter, per_compute, wer_compute
from ..utils.profiler import StepTimer, Trace
from ..vocab import EOS_ID, IGNORE_ID, SOS_ID, TOTAL_PHONEMES
from . import checkpoint as ckpt
from .memguard import GuardedTrainStep
from .schedule import make_optimizer
from .state import TrainState
from .steps import (PLAN_KEYS, EpochConst, GraphedStep, make_epoch_fused_step,
                    make_epoch_fused_step_mesh, make_eval_step, make_train_step)


def attach_plans(batch: Dict, rng: np.random.Generator, cfg) -> Dict:
    """Add integer augmentation plans to a raw uint8 batch (JAX
    ``trainer.attach_plans`` with train=True): LRW clips (lang_id 0) get
    per-frame crop offsets in [0, raw-crop], LRW-1000 clips one per-clip
    offset in [0, (raw-crop)//2]; flip and FrameRemoval apply to both."""
    B, T = batch["clip_u8"].shape[:2]
    raw, crop = batch["clip_u8"].shape[2], cfg.data.crop_size
    lang = np.asarray(batch.get("lang_id", np.zeros(B, np.int32)))
    per_frame = (lang == 0) & (not cfg.data.per_clip_crop)
    clip_hi = np.where(lang == 0, raw - crop, (raw - crop) // 2)
    offsets, flip, fmap = make_train_plans(
        rng, B, T, raw, crop, cfg.data.frame_removal_p,
        per_frame_mask=per_frame, clip_hi=clip_hi,
        random_drop_p=cfg.data.random_drop_p)
    return dict(batch, offsets=offsets, flip=flip, frame_map=fmap)


def decode_to_phonemes(pred_row: Sequence[int], gold_row: Sequence[int],
                       vocab: Sequence[str] = TOTAL_PHONEMES
                       ) -> Tuple[List[str], List[str]]:
    """The reference eval protocol on one sample (test.py:185-212): gold
    filtered of specials; the prediction truncated to len(gold)+1 raw
    tokens, then filtered."""
    specials = (SOS_ID, EOS_ID, IGNORE_ID)
    golds = [vocab[i] for i in gold_row if i not in specials]
    preds = [vocab[i] for i in list(pred_row)[:len(golds) + 1]
             if i not in specials]
    return preds, golds


class _Scores:
    """Joined strings for WER and phoneme lists for PER, one per sample."""

    def __init__(self):
        self.pred_txt, self.gold_txt, self.pred_ph, self.gold_ph = [], [], [], []

    def add(self, ys: np.ndarray, gold: np.ndarray) -> None:
        for n in range(ys.shape[0]):
            preds, golds = decode_to_phonemes(ys[n], gold[n])
            self.pred_txt.append("".join(preds))
            self.gold_txt.append("".join(golds))
            self.pred_ph.append(preds)
            self.gold_ph.append(golds)

    def finish(self) -> Tuple[float, float]:
        return (wer_compute(self.pred_txt, self.gold_txt),
                per_compute(self.pred_ph, self.gold_ph))


def epoch_order(seed: int, n: int, batch: int, data: int = 1,
                max_steps: Optional[int] = None) -> np.ndarray:
    """The epoch-fused route's (n_steps, batch) dataset indices (JAX
    ``_epoch_const`` / ``_epoch_const_mesh``): from ``default_rng(seed)``
    one permutation per data index of its n / data rows, data index d's
    taking batch columns d B/data:(d+1) B/data; at data 1 the single
    route's permutation of the dataset.  ``max_steps`` truncates."""
    rng = np.random.default_rng(seed)
    bl, nl = batch // data, n // data
    perms = [rng.permutation(nl) + d * nl for d in range(data)]
    n_steps = nl // bl
    if max_steps is not None:
        n_steps = min(n_steps, max_steps)
    order = np.empty((n_steps, batch), np.int64)
    for d in range(data):
        order[:, d * bl:(d + 1) * bl] = perms[d][:n_steps * bl].reshape(
            n_steps, bl)
    return order


def _stripes(idx, world: int) -> List[np.ndarray]:
    """The processes' stripes of a global index batch (``Batcher``'s)."""
    idx = np.asarray(idx)
    return [idx[p::world] for p in range(world)]


class Trainer:
    """Config-driven trainer on one device: the card unless ``device`` (or
    a given ``model``'s device, or the ``mesh``'s) says otherwise.  It
    trains and evaluates every workload: ``sbl`` / ``sbl_stage2``, ``lrw`` /
    ``lrw1000`` (``validate_seq2seq``) and ``classify``
    (``validate_classify``).  ``mesh`` (a ``parallel.DataMesh``) makes it
    one process of a data x model grid; without one, ``cfg.mesh`` data x
    model > 1 joins the process group torchrun describes in the
    environment.  A given ``model`` is sharded over the mesh's model group
    unless it already is."""

    def __init__(self, cfg, train_dataset, valid_datasets: Optional[Dict] = None,
                 checkpoint_dir: Optional[str] = None, device=None,
                 cache_on_device: bool = False,
                 model: Optional[torch.nn.Module] = None, mesh=None,
                 tensorboard_dir: Optional[str] = None,
                 profile_dir: Optional[str] = None):
        self.cfg = cfg
        mesh_cfg = getattr(cfg, "mesh", None)
        if mesh is None and mesh_cfg is not None and (mesh_cfg.data > 1
                                                      or mesh_cfg.model > 1):
            from ..parallel import make_mesh
            mesh = make_mesh(mesh_cfg.data, mesh_cfg.model, device)
        self.mesh = mesh
        self.is_lead = mesh is None or mesh.global_rank == 0
        # the processes that validate: data index 0's model group
        self.evaluates = mesh is None or mesh.rank == 0
        if mesh is not None:
            device = mesh.device
        elif device is None and model is not None:
            device = next(model.parameters()).device
        self.device = resolve_device(device)
        self.logger = get_logger()
        self.timer = StepTimer(batch_size=cfg.batch_size)
        self.model = model if model is not None else build_model(cfg, self.device)
        if mesh is not None:
            if mesh.model_size > 1 and not getattr(self.model, "tp_plan", None):
                from ..parallel import shard_model
                shard_model(self.model, mesh)
            # every process starts from data index 0's weights and statistics
            mesh.broadcast_(list(self.model.state_dict().values()))
        self.writer = None
        if tensorboard_dir and self.is_lead:
            from ..utils.tensorboard import SummaryWriter
            self.writer = SummaryWriter(tensorboard_dir)
        self.profile_dir = profile_dir
        self.generator = torch.Generator().manual_seed(cfg.seed)
        self.np_rng = np.random.default_rng(cfg.seed)
        self.reset_optimizer()
        self.train_dataset = train_dataset
        self.valid_datasets = valid_datasets or {}
        self.checkpoint_dir = checkpoint_dir
        self.best_metric = float("inf")
        # a device-resident dataset: every clip uploaded once, each batch
        # gathered on the card by index (only the labels and plans cross
        # the bus); for datasets that fit the card's memory
        self.cache_on_device = cache_on_device
        self._dev_clips: Optional[torch.Tensor] = None
        self._host_small: Optional[Dict[str, np.ndarray]] = None
        self._cache_block: Optional[Tuple[int, int]] = None
        self._const: Optional[EpochConst] = None

    def reset_optimizer(self) -> None:
        """A fresh Adam and train step at update 0 (after a transfer load,
        as the reference rebuilds its optimizer, train.py:106-109)."""
        self.optimizer = make_optimizer(self.model, self.cfg.optim)
        step = make_train_step(self.model, self.optimizer, self.cfg, self.mesh)
        self.train_step = GuardedTrainStep(
            step, rebuild=(None if self.cfg.remat_frontend
                           else lambda: self._remat_rebuild(step)),
            logger=self.logger)
        self._step = step
        self.fused_step = None   # the epoch-fused route's, built at first use
        self.state: TrainState = step.state
        self.eval_step = make_eval_step(self.model, self.cfg)

    def _remat_rebuild(self, step):
        """The memory guard's cheaper step (JAX ``_rebuild_with_remat``): the
        same step, parameters and optimizer, with the frontend's blocks
        recomputed in the backward."""
        self.cfg = dataclasses.replace(self.cfg, remat_frontend=True)
        self.model.frontend.resnet.remat = True
        return step

    # ---------------------------------------------------------- checkpoints
    def rng_state(self) -> Dict:
        return {"np": self.np_rng.bit_generator.state,
                "torch": self.generator.get_state()}

    def save(self, path: str, epoch: int = 0, is_best: bool = False) -> None:
        """Write the checkpoint, whole (global rank 0 writes; the others
        gather with it and wait for it)."""
        ckpt.save_checkpoint(path, self.state, epoch=epoch,
                             best_metric=self.best_metric, is_best=is_best,
                             rng_state=self.rng_state(), write=self.is_lead)
        if self.mesh is not None:
            self.mesh.barrier()

    def restore(self, path: str) -> int:
        """Resume from a checkpoint: model, optimizer, update count, best
        metric and the random number states (every process reads the same
        file and keeps its slices).  Returns its epoch."""
        _, epoch, self.best_metric, rng = ckpt.restore_checkpoint(path,
                                                                  self.state)
        # a captured step holds the optimizer state the load replaced
        self.fused_step = None
        if rng:
            self.np_rng.bit_generator.state = rng["np"]
            self.generator.set_state(rng["torch"])
        return epoch

    # ---------------------------------------------------------------- train
    def _make_sampler(self, epoch: int) -> Optional[TwoStreamBatchSampler]:
        """Fixed-ratio two-stream batches (the reference's
        TwoStreamBatchSampler): ``cfg.secondary_batch_size`` samples per
        batch from the secondary (LRW-1000) stream, the rest from the
        primary (LRW) one.  Needs a dataset with ``stream_indices()``."""
        sec = self.cfg.secondary_batch_size
        if not sec:
            return None
        streams = getattr(self.train_dataset, "stream_indices", None)
        if streams is None:
            raise ValueError(
                "secondary_batch_size set but the train dataset has no "
                "stream_indices() (use MixedBilingualDataset or a synthetic "
                "'all' dataset)")
        primary, secondary = streams()
        return TwoStreamBatchSampler(primary, secondary, self.cfg.batch_size,
                                     sec, seed=self.cfg.seed + epoch)

    def _mesh_fused_ok(self) -> bool:
        """JAX ``_mesh_fused_ok``: the mesh's epoch-fused route needs the
        batch and the dataset to tile evenly over the data axis (each data
        index gathers its batches from its own block of the dataset)."""
        if self.mesh is None:
            return False
        return (self.cfg.batch_size % self.mesh.size == 0
                and len(self.train_dataset) % self.mesh.size == 0)

    def _fused_route(self) -> bool:
        """The cached dataset's route (JAX ``train_epoch``): epoch-fused
        unless ``SBL_NO_EPOCH_FUSED`` is set or the mesh does not tile."""
        return (not os.environ.get("SBL_NO_EPOCH_FUSED")
                and (self.mesh is None or self._mesh_fused_ok()))

    def _ensure_device_cache(self, shard: bool = False) -> None:
        """Upload the dataset's clips to the device once: all N, or with
        ``shard`` (the fused route under a mesh) only the data index's block
        of N/W rows.  The label-like arrays stay on the host, whole."""
        W, d = self._world()
        n = len(self.train_dataset)
        block = (d * n // W, (d + 1) * n // W) if shard else (0, n)
        if self._dev_clips is not None and self._cache_block == block:
            return
        ds = self.train_dataset
        samples = [ds[i] for i in range(n)]
        clips = np.stack([samples[i]["clip_u8"] for i in range(*block)])
        self._dev_clips = torch.from_numpy(clips).to(self.device)
        self._host_small = {k: np.stack([s[k] for s in samples])
                            for k in samples[0] if k != "clip_u8"}
        self._cache_block, self._const, self.fused_step = block, None, None
        self.logger.info(f"device cache: {len(clips)} of {n} clips "
                         f"({clips.nbytes / 1e9:.2f} GB) resident")

    def _world(self) -> Tuple[int, int]:
        """(data indices, this one's): (1, 0) without a mesh."""
        return (1, 0) if self.mesh is None else (self.mesh.size, self.mesh.rank)

    def _device_batches(self, epoch: int) -> Iterator[Dict]:
        """Batches gathered on the card from the resident dataset, in the
        ``Batcher``'s shuffled order with the same plan draws (with a mesh,
        the process's stripe of each, with its rows of the global plans)."""
        self._ensure_device_cache(shard=False)
        B = self.cfg.batch_size
        W, r = self._world()
        order = np.random.default_rng(self.cfg.seed + epoch).permutation(
            len(self.train_dataset))
        for s in range(0, len(order) // B * B, B):
            idx = order[s:s + B]
            local = _stripes(idx, W)[r]
            batch = self._with_plans(
                {k: v[local] for k, v in self._host_small.items()}, idx,
                self._host_small.get("lang_id"))
            batch["clip_u8"] = self._dev_clips.index_select(
                0, torch.from_numpy(local).to(self.device))
            yield batch

    def _host_batches(self, batcher: Batcher) -> Iterator[Dict]:
        """The ``Batcher``'s batches (a process's stripes of them) with
        their plans."""
        ds = self.train_dataset
        # every sample's lang_id without loading it, where the dataset can
        lang_ids = getattr(ds, "lang_ids", None)
        lang_ids = None if lang_ids is None or self.mesh is None else lang_ids()
        for idx in batcher.index_batches():
            local = batcher._collate([ds[int(i)] for i in batcher._local(idx)])
            yield self._with_plans(local, idx, lang_ids)

    def _with_plans(self, local: Dict, idx, lang_ids) -> Dict:
        """``local``, this process's stripe of the global index batch
        ``idx``, with its rows of the plans drawn for the whole batch, the
        stripes one after another (one process: the batch's plans, as
        ``attach_plans`` draws them).  lang_ids: every sample's lang_id by
        dataset index, or None to take it from ``local`` (one process) or
        from the dataset."""
        W, r = self._world()
        concat = np.concatenate(_stripes(idx, W))
        if lang_ids is not None:
            small = {"lang_id": np.asarray(lang_ids)[concat]}
        elif W == 1:
            small = {k: local[k] for k in ("lang_id",) if k in local}
        else:
            small = {"lang_id": np.array(
                [self.train_dataset[int(i)].get("lang_id", 0) for i in concat],
                np.int32)}
        frame = (local["clip_u8"].shape[1:] if self._dev_clips is None
                 else self._dev_clips.shape[1:])
        stub = np.broadcast_to(np.uint8(0), (len(concat),) + tuple(frame))
        plans = attach_plans({**small, "clip_u8": stub}, self.np_rng, self.cfg)
        n = len(concat) // W
        return dict(local, **{k: plans[k][r * n:(r + 1) * n] for k in PLAN_KEYS})

    def _epoch_plans(self, order: np.ndarray) -> Dict[str, np.ndarray]:
        """Each step's plans for the global batch ``order[s]``, drawn from
        ``np_rng`` as JAX's ``_epoch_const`` draws them (each sample's
        lang_id from its global row), stacked (n_steps, B, ...)."""
        frame = tuple(self._dev_clips.shape[1:])
        plans = {k: [] for k in PLAN_KEYS}
        for idx in order:
            small = {k: v[idx] for k, v in self._host_small.items()}
            stub = np.broadcast_to(np.uint8(0), (len(idx),) + frame)
            batch = attach_plans({**small, "clip_u8": stub}, self.np_rng,
                                 self.cfg)
            for k in PLAN_KEYS:
                plans[k].append(batch[k])
        return {k: np.stack(v) for k, v in plans.items()}

    def _load_const(self, order: np.ndarray, plans: Dict[str, np.ndarray],
                    cols: slice) -> Tuple[EpochConst, int]:
        """Draw the epoch's steps' random numbers from ``generator`` (one
        step seed a step, as the per-step route draws it) and copy the
        epoch into the device buffers, keeping batch columns ``cols``."""
        step, n_steps = self._step, len(order)
        rate = getattr(getattr(self.model, "decoder", None),
                       "teacher_forcing_rate", 0.0)
        rows = [draw_step_random(
            int(torch.randint(0, 2 ** 62, (1,), generator=self.generator)),
            step.layout, rate) for _ in range(n_steps)]
        seeds = np.stack([r[0] for r in rows]).reshape(n_steps, -1)
        coins = np.stack([r[1] for r in rows]).reshape(n_steps, -1)
        if self._const is None:
            W = self._world()[0] if self._mesh_fused_ok() else 1
            n, B = len(self.train_dataset), self.cfg.batch_size
            shapes = {k: (v.shape[2:], torch.from_numpy(v).dtype)
                      for k, v in plans.items()}
            per_sample = {k: torch.from_numpy(v[slice(*self._cache_block)]).to(
                self.device) for k, v in self._host_small.items()}
            self._const = EpochConst(self._dev_clips, per_sample,
                                     (n // W) // (B // W), B // W, shapes,
                                     step.layout, len(step.metric_keys))
        self._const.load(self.state.step, order[:, cols],
                         {k: v[:, cols] for k, v in plans.items()}, seeds, coins)
        return self._const, n_steps

    def _epoch_const(self, epoch: int, max_steps: Optional[int] = None
                     ) -> Tuple[EpochConst, int]:
        """JAX ``_epoch_const``: the epoch's shuffle order and every step's
        plans (and, here, random numbers) for the fused cached step, drawn
        only for the steps that will run, so a ``max_steps``-truncated epoch
        advances ``np_rng`` and ``generator`` as far as the per-step route
        does; the two cached routes draw the same batches.  Returns (the
        device buffers, n_steps)."""
        self._ensure_device_cache(shard=False)
        order = epoch_order(self.cfg.seed + epoch, len(self.train_dataset),
                            self.cfg.batch_size, 1, max_steps)
        return self._load_const(order, self._epoch_plans(order), slice(None))

    def _epoch_const_mesh(self, epoch: int, max_steps: Optional[int] = None
                          ) -> Tuple[EpochConst, int]:
        """JAX ``_epoch_const_mesh``: a permutation per data index (data
        index d's batch columns d B/W:(d+1) B/W draw only from its resident
        rows [d N/W, (d+1) N/W) -- torch DistributedSampler's semantics),
        the plans drawn on the global rows (``attach_plans`` reads each
        sample's lang_id); this process keeps its columns of both, and its
        rows of the dataset on its card."""
        W, d = self._world()
        self._ensure_device_cache(shard=True)
        B = self.cfg.batch_size
        order = epoch_order(self.cfg.seed + epoch, len(self.train_dataset), B,
                            W, max_steps)
        return self._load_const(order, self._epoch_plans(order),
                                slice(d * B // W, (d + 1) * B // W))

    def _ensure_fused_step(self):
        """JAX ``_ensure_fused_step``: the epoch-fused step of the workload's
        body over the epoch buffers, under its own memory guard (whose
        rebuild turns ``remat_frontend`` on before anything is captured);
        on a card without a mesh, or with an NCCL one, a ``GraphedStep``,
        else (the CPU, gloo) the fused step run eagerly."""
        if self.fused_step is not None:
            return self.fused_step
        const = self._const
        fused = (make_epoch_fused_step(self._step, const) if self.mesh is None
                 else make_epoch_fused_step_mesh(self._step, const, self.mesh))
        guarded = GuardedTrainStep(
            fused, rebuild=(None if self.cfg.remat_frontend
                            else lambda: self._remat_rebuild(fused)),
            logger=self.logger)
        graph = self.device.type == "cuda" and (self.mesh is None
                                                or self.mesh.graphable)
        if graph:
            self.fused_step = GraphedStep(guarded, self.state, const,
                                          self.device, logger=self.logger)
            route = "one CUDA graph a step (captured after one eager step)"
        else:
            self.fused_step = lambda i: guarded(i, None)
            route = (f"eager on {self.device.type}"
                     + ("" if self.mesh is None else f" ({self.mesh.backend})"))
        if self.is_lead:
            self.logger.info(f"cached dataset: epoch-fused route, {route}")
        return self.fused_step

    def _train_epoch_fused(self, epoch: int, max_steps: Optional[int],
                           history: Optional[List[Dict[str, float]]]) -> float:
        """JAX ``_train_epoch_fused``: one upload of the epoch's order,
        plans and random numbers, then one fused step (one graph replay on a
        card) a step; each step's metrics are read from the ring while the
        next step runs."""
        const, n_steps = (self._epoch_const_mesh(epoch, max_steps)
                          if self.mesh is not None
                          else self._epoch_const(epoch, max_steps))
        step_fn = self._ensure_fused_step()
        consume = self._consumer(epoch, n_steps, history)
        pending, trace = None, None
        base_step = self.state.step
        try:
            for i in range(n_steps):
                if self.profile_dir is not None and epoch == 0 and i == 1:
                    if isinstance(step_fn, GraphedStep):
                        step_fn.ready(i)   # the trace holds replays only
                    trace = self._start_trace()
                with self.timer.step():
                    step_fn(i)
                    if pending is not None:
                        consume(*pending)
                    pending = (i, base_step + i + 1, const.ring[i])
                if trace is not None and i >= 3:
                    self._stop_trace(trace)
                    trace = None
            if pending is not None:
                consume(*pending)
        finally:
            if trace is not None:
                self._stop_trace(trace)
        return consume.losses.avg

    def _consumer(self, epoch: int, n_batches: int,
                  history: Optional[List[Dict[str, float]]]):
        """``consume(i, step_no, metrics)``: read a step's metrics (a dict
        of device scalars, or a row of the fused route's ring), halt on a
        non-finite loss, log; ``consume.losses`` is the epoch's meter."""
        losses = AverageMeter()
        keys = self._step.metric_keys

        def consume(i, step_no, metrics):
            if torch.is_tensor(metrics):
                metrics = dict(zip(keys, metrics.tolist()))
            loss = float(metrics["loss"])
            # a NaN loss halts with a diagnostic instead of corrupting Adam
            if not np.isfinite(loss):
                raise FloatingPointError(
                    f"non-finite loss {loss} at step {step_no} (epoch "
                    f"{epoch}, batch {i}); metrics="
                    f"{ {k: float(v) for k, v in metrics.items()} }")
            losses.update(loss)
            if history is not None:
                history.append({k: float(v) for k, v in metrics.items()})
            if self.writer is not None:
                self.writer.add_scalar("train/loss", loss, step_no)
            if i % 50 == 0 and self.is_lead:
                self.logger.info(
                    f"Epoch: [{epoch}][{i}/{n_batches}]\tLoss {losses.val:.5f} "
                    f"({losses.avg:.5f})\t{self.timer.clips_per_sec:.1f} clips/s")

        consume.losses = losses
        return consume

    def _start_trace(self) -> Trace:
        # step 0 builds kernels and picks cuDNN algorithms
        return Trace(self.profile_dir, self.device,
                     "trace.json" if self.mesh is None else
                     f"trace_rank{self.mesh.global_rank}.json")

    def train_epoch(self, epoch: int = 0, max_steps: Optional[int] = None,
                    history: Optional[List[Dict[str, float]]] = None) -> float:
        """One epoch (at most ``max_steps`` steps); returns the mean loss and
        appends each step's metrics to ``history`` when one is given.  A
        step's loss is read while the next step runs, so the read does not
        hold the card idle."""
        if self.cache_on_device:
            if self.cfg.secondary_batch_size:
                raise ValueError(
                    "cache_on_device uses plain shuffling and would drop the "
                    "fixed-ratio TwoStreamBatchSampler protocol; unset "
                    "secondary_batch_size or the device cache")
            if self._fused_route():
                return self._train_epoch_fused(epoch, max_steps, history)
            n_batches = len(self.train_dataset) // self.cfg.batch_size
            it = self._device_batches(epoch)
        else:
            W, r = self._world()
            batcher = Batcher(self.train_dataset, self.cfg.batch_size,
                              shuffle=True, seed=self.cfg.seed + epoch,
                              sampler=self._make_sampler(epoch),
                              process_index=r, process_count=W)
            n_batches = len(batcher)
            it = self._host_batches(batcher)
        if max_steps is not None:
            # bound the source: the producer and the prefetch pull ahead,
            # and every pull draws plans from the shared np_rng
            it = itertools.islice(it, max_steps)
        it = background_iter(it)

        consume = self._consumer(epoch, n_batches, history)

        pending, trace = None, None
        base_step = self.state.step
        try:
            for i, batch in enumerate(prefetch_to_device(it, self.device)):
                if self.profile_dir is not None and epoch == 0 and i == 1:
                    trace = self._start_trace()
                with self.timer.step():
                    metrics = self.train_step(batch, self.generator)
                    if pending is not None:
                        consume(*pending)
                    pending = (i, base_step + i + 1, metrics)
                if trace is not None and i >= 3:
                    self._stop_trace(trace)
                    trace = None
            if pending is not None:
                consume(*pending)
        finally:
            if trace is not None:
                self._stop_trace(trace)
        return consume.losses.avg

    def _stop_trace(self, trace: Trace) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        path = trace.stop()
        if self.is_lead:
            self.logger.info(f"profiler trace written to {path}")

    # ----------------------------------------------------------------- eval
    def validate_seq2seq(self, dataset, max_batches: Optional[int] = None,
                         beam_size: Optional[int] = None,
                         bigram_logp=None) -> Dict[str, float]:
        """Decode every sample (the ragged tail batch kept) and score WER/PER
        (JAX ``validate_seq2seq``): greedily by default, both directions for
        SBL.  With ``beam_size``, batched beam search: paired bidirectional
        frontiers for SBL (``decode/beam.py::sbl_beam_search``), or the
        unidirectional beam, optionally biased by a (V, V) bigram log table
        (the LRW-1000 eval protocol); the best hypothesis is scored."""
        bidi = self.cfg.decoder.bidirectional
        beam_fn = None
        if beam_size is not None and bidi:
            from ..decode.beam import make_sbl_beam_decoder
            beam_fn = make_sbl_beam_decoder(self.model, beam_size)
        elif beam_size is not None:
            from ..decode.beam import make_uni_beam_decoder
            beam_fn = make_uni_beam_decoder(self.model, beam_size,
                                            bigram_logp=bigram_logp)
        crop = self.cfg.data.crop_size
        l2r, r2l = _Scores(), _Scores()
        batcher = Batcher(dataset, self.cfg.batch_size, shuffle=False,
                          drop_last=False)
        for i, batch in enumerate(prefetch_to_device(iter(batcher), self.device)):
            if max_batches is not None and i >= max_batches:
                break
            gold = batch["labels"].cpu().numpy()
            if beam_fn is not None:
                self.model.eval()
                video = device_ingest(batch["clip_u8"], crop,
                                      self.model.frontend.dtype,
                                      n_frames=batch.get("n_frames"))
                if bidi:
                    tok_l, tok_r, _ = beam_fn(video)
                    l2r.add(tok_l[:, 0].cpu().numpy(), gold)
                    r2l.add(tok_r[:, 0].cpu().numpy(),
                            batch["labels_reverse"].cpu().numpy())
                else:
                    tokens, _ = beam_fn(video)
                    l2r.add(tokens[:, 0].cpu().numpy(), gold)
            elif bidi:
                out = recognize_batch(self.model, batch["clip_u8"], crop,
                                      n_frames=batch.get("n_frames"))
                l2r.add(out.ys_l2r.cpu().numpy(), gold)
                r2l.add(out.ys_r2l.cpu().numpy(),
                        batch["labels_reverse"].cpu().numpy())
            else:
                l2r.add(self.eval_step(batch).cpu().numpy(), gold)
        res = {}
        res["l2r_wer"], res["l2r_per"] = l2r.finish()
        if bidi:
            res["r2l_wer"], res["r2l_per"] = r2l.finish()
        return res

    def validate_classify(self, dataset, max_batches: Optional[int] = None
                          ) -> Dict[str, float]:
        """Word and language accuracy of the ``classify`` model over every
        sample (the ragged tail batch kept), as JAX's ``validate_classify``
        counts them: a sample whose label is below 0 counts in the total
        and never as correct."""
        n = w_ok = l_ok = 0
        batcher = Batcher(dataset, self.cfg.batch_size, shuffle=False,
                          drop_last=False)
        for i, batch in enumerate(prefetch_to_device(iter(batcher), self.device)):
            if max_batches is not None and i >= max_batches:
                break
            word_logits, lang_logits = self.eval_step(batch)
            w_ok += int((word_logits.argmax(-1) == batch["word_id"]).sum())
            l_ok += int((lang_logits.argmax(-1) == batch["lang_id"]).sum())
            n += word_logits.shape[0]
        return {"word_acc": w_ok / max(n, 1), "lang_acc": l_ok / max(n, 1)}

    def validate(self, dataset, max_batches: Optional[int] = None,
                 beam_size: Optional[int] = None,
                 bigram_logp=None) -> Dict[str, float]:
        """The workload's validation: ``validate_classify`` for
        ``classify`` (the decode options do not apply), else
        ``validate_seq2seq``."""
        if model_kind(self.cfg) == "classify":
            return self.validate_classify(dataset, max_batches)
        return self.validate_seq2seq(dataset, max_batches, beam_size=beam_size,
                                     bigram_logp=bigram_logp)

    def score(self, metrics: Dict[str, float]) -> float:
        """One eval set's share of the best-model metric, lower is better:
        -word_acc for ``classify`` (JAX trainer.py:657-663), l2r WER
        otherwise (train.py:161-175)."""
        if model_kind(self.cfg) == "classify":
            return -metrics["word_acc"]
        return metrics["l2r_wer"]

    # ------------------------------------------------------------------ fit
    def fit(self, epochs: int, max_steps_per_epoch: Optional[int] = None,
            max_eval_batches: Optional[int] = None, start_epoch: int = 0
            ) -> Dict:
        """Epochs ``start_epoch .. epochs-1``: train, validate every eval
        set, keep the best (the least sum of l2r WER, for ``classify`` the
        least -sum of word accuracies; the train loss without eval sets) and
        checkpoint to ``checkpoint_dir`` after each."""
        last: Dict = {}
        loss = float("nan")
        for epoch in range(start_epoch, epochs):
            t0 = time.time()
            loss = self.train_epoch(epoch, max_steps=max_steps_per_epoch)
            if self.is_lead:
                self.logger.info(f"epoch {epoch} train_loss {loss:.4f} "
                                 f"({time.time() - t0:.1f}s)")
            metric = loss
            if self.valid_datasets:
                metric, results = self._validate_all(max_eval_batches)
                last.update(results)
            is_best = metric < self.best_metric
            self.best_metric = min(metric, self.best_metric)
            if self.checkpoint_dir:
                self.save(self.checkpoint_dir, epoch=epoch, is_best=is_best)
        last["train_loss"] = loss
        return last

    def _validate_all(self, max_eval_batches: Optional[int]):
        """(best-model metric, {name: metrics}) over the eval sets, from
        data index 0's processes (the model is the same in every data
        index); logged by global rank 0, and written as JAX's
        ``{name}/{metric}`` scalars for the seq2seq workloads."""
        metric, results = 0.0, {}
        if self.evaluates:
            for name, ds in self.valid_datasets.items():
                results[name] = self.validate(ds, max_eval_batches)
                metric += self.score(results[name])
                if self.is_lead:
                    self.logger.info(f"{name}: {results[name]}")
                if self.writer is not None and model_kind(self.cfg) != "classify":
                    for k, v in results[name].items():
                        self.writer.add_scalar(f"{name}/{k}", v, self.state.step)
        if self.mesh is not None:
            metric, results = self.mesh.broadcast_object((metric, results))
        return metric, results


class TrainResult(NamedTuple):
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    history: List[Dict[str, float]]   # one dict of metrics per step


def train_steps(cfg, dataset, n_steps: int, device=None,
                seed: Optional[int] = None,
                model: Optional[torch.nn.Module] = None) -> TrainResult:
    """Run ``n_steps`` train steps of ``cfg``'s workload through a
    ``Trainer`` on ``device`` (the card by default), on the host batch
    path, without validation or checkpoints.

    The model is built from ``seed`` (default ``cfg.seed``) unless one is
    given.  The seed also drives the batch order (``seed + epoch``), the
    plans and the steps' random numbers.  Returns the trained model, its
    optimizer and the metrics of every step."""
    if seed is not None:
        cfg = dataclasses.replace(cfg, seed=seed)
    if len(dataset) < cfg.batch_size:
        raise ValueError(f"a dataset of {len(dataset)} samples has no full "
                         f"batch of {cfg.batch_size}")
    tr = Trainer(cfg, dataset, device=device, model=model)
    history: List[Dict[str, float]] = []
    epoch = 0
    while len(history) < n_steps:
        tr.train_epoch(epoch, max_steps=n_steps - len(history), history=history)
        epoch += 1
    return TrainResult(tr.model, tr.optimizer, history)
