"""The train steps of every workload (counterpart of the JAX package's
``training/steps.py``: ``make_sbl_train_body``, ``make_uni_train_body``,
``make_classify_train_body``), one shape for all three:

    uint8 clips + plans -> train ingest (K6 under PALLAS_INGEST)
    -> frontend (batch-statistics BN; K7/K8 under PALLAS_BN)
    -> encoder -> the workload's head, with dropout (K3 forward, K4
       backward in every attention)
    -> the workload's loss -> backward
    -> frozen subtrees' gradients zeroed -> Adam with the Noam lr

The heads and losses: ``sbl`` the teacher-forced bidirectional decode and
0.5 * (l2r + r2l), label-smoothed; ``lrw`` / ``lrw1000`` the parallel
teacher-forced unidirectional decode and one label-smoothed loss;
``classify`` the word and language heads and ``classify_loss``.

The BN running statistics update inside the forward.  Frozen subtrees
(``cfg.freeze_prefixes``) get ZERO gradients, not None, as JAX's
``_freeze_grads`` gives them: Adam's moments then keep moving those weights,
as they do under optax (``torch.optim.Adam`` would skip a None gradient).

The step's random numbers come from the ``torch.Generator`` the caller
passes (a CPU one: drawing from it never waits for the device): one seed per
step builds the forward's ``DropoutRNG``.

With a ``mesh`` (``parallel.DataMesh``) the step is one process's share of
the step on the data indices' batches put one after another
(``parallel/mesh.py``): its loss terms are weighted by their share of the
global count (over the data group), the gradients averaged over the data
group before the frozen subtrees are zeroed and the gradients clipped, and
the metrics it returns are the global ones.  A model sharded over the
mesh's model group (``parallel.shard_model``) computes the unsharded
step: its processes see the same batch, draw the same seeds, coins and
elementwise masks, and each attention draws its heads' masks (the
kernels' head offset); the BatchNorm statistics are synchronised over the
data group only.  Every process runs the same collectives in the same
order, the decoder's checkpointed recompute included.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Sequence

import torch

from .. import ops
from ..config import model_kind
from ..data.ingest import device_ingest
from ..models.frontend import pallas_bn_on
from ..models.layers import DropoutRNG, cast_dense_weights
from ..ops.ingest import MAX_OFFSET, ingest_train, ingest_train_plain
from ..recognize import recognize_batch
from .loss import cal_performance, classify_terms, token_count
from .state import TrainState

PLAN_KEYS = ("offsets", "flip", "frame_map")


def freeze_grads(model: torch.nn.Module, freeze_prefixes: Sequence[str]) -> None:
    """Zero the gradients of every parameter under a frozen top-level
    subtree (the name's first component)."""
    for name, p in model.named_parameters():
        if name.split(".", 1)[0] in freeze_prefixes:
            p.grad = torch.zeros_like(p)


def kernel_ingest_on(raw: int, crop: int) -> bool:
    """``PALLAS_INGEST`` is set and the crop offsets fit the kernel's range
    (JAX ``_ingest_train``'s branch on shape)."""
    return bool(os.environ.get("PALLAS_INGEST")) and raw - crop <= MAX_OFFSET


def ingest_train_batch(batch: Dict[str, torch.Tensor], crop: int,
                       dtype: torch.dtype, use_kernels: bool = True
                       ) -> torch.Tensor:
    """Train ingest of a batch with plans (JAX ``_ingest_train``, reading
    ``PALLAS_INGEST`` where it does, at every step): K6 (or, with
    ``use_kernels`` False, its plain version) when the switch is set and the
    frames are at most MAX_OFFSET wider than the crop, else the train branch
    of ``device_ingest``."""
    clips = batch["clip_u8"]
    H, W = clips.shape[2:]
    if kernel_ingest_on(max(H, W), crop):
        fn = ingest_train if use_kernels else ingest_train_plain
        return fn(clips, *(batch[k] for k in PLAN_KEYS), crop, dtype,
                  n_frames=batch.get("n_frames"))
    return device_ingest(clips, crop, dtype, n_frames=batch.get("n_frames"),
                         **{k: batch[k] for k in PLAN_KEYS})


def frontend_bn_count(fcfg) -> int:
    """BatchNorms in the frontend: the stem's, two per block and one per
    block with a downsample (stride 2, or a change of width)."""
    n, c_in = 1, fcfg.conv3d_channels
    for stage, (ch, blocks) in enumerate(zip(fcfg.resnet_channels,
                                             fcfg.resnet_blocks)):
        for b in range(blocks):
            n += 2 + int((stage > 0 and b == 0) or c_in != ch)
            c_in = ch
    return n


def expected_launches(cfg) -> Dict[str, int]:
    """Kernel launches one train step of ``cfg``'s workload makes on the
    kernel path: K2 once; K3 once per encoder layer and per decoder
    attention (``sbl``: self and cross per layer and decode step, both
    directions in one launch, and once more for each decode step in the
    checkpoint's recompute; ``lrw`` / ``lrw1000``: self and cross per layer,
    one parallel pass; ``classify``: none); K4 once per K3 of the forward;
    no K1, K5 or layout twin; K6 once under ``PALLAS_INGEST``; K7 once per
    frontend BatchNorm in the forward and K8 once per BatchNorm in the
    backward under ``PALLAS_BN`` (as the environment stands when this is
    called); with ``remat_frontend`` K7 once more for each BatchNorm of the
    ResNet blocks (every one but the stem's), in the recompute."""
    enc = cfg.dims.n_enc_layers
    d = cfg.decoder
    if d is None:
        dec_fwd = dec_bwd = 0
    elif d.bidirectional:
        dec_bwd = 2 * d.maxlen * cfg.dims.n_dec_layers
        dec_fwd = dec_bwd * (2 if cfg.remat_decoder else 1)
    else:
        dec_fwd = dec_bwd = 2 * cfg.dims.n_dec_layers
    bns = frontend_bn_count(cfg.frontend) if pallas_bn_on(False) else 0
    recomputed = bns - 1 if bns and getattr(cfg, "remat_frontend", False) else 0
    return dict(dict.fromkeys(ops.launch_counts(), 0), stack_frames=1,
                small_mha_dropout_fwd_flat=enc + dec_fwd,
                small_mha_dropout_bwd_flat=enc + dec_bwd,
                ingest_train=int(kernel_ingest_on(cfg.data.raw_size,
                                                  cfg.data.crop_size)),
                channel_sums=bns + recomputed, channel_sums_pair=bns)


def _mark(marks: Optional[List], name: str) -> None:
    if marks is not None:
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        marks.append((name, event))


def _global_loss(mesh, terms, metrics):
    """(the objective whose gradient, averaged over the processes, is the
    global loss's; the global loss; the global metrics).  terms: (name or
    None, weight, local mean, local count) per term of the loss; metrics:
    the named terms' means and counts to sum.  One collective."""
    k = len(terms)
    counted = [key for key in metrics if key not in {t[0] for t in terms}]
    local = torch.stack([m.detach().float() * n for _, _, m, n in terms]
                        + [n.float() for *_, n in terms]
                        + [metrics[key].float() for key in counted])
    mesh.all_reduce_(local)
    sums, counts = local[:k], local[k:2 * k].clamp(min=1)
    objective = sum(w * m * (mesh.size * n / counts[i])
                    for i, (_, w, m, n) in enumerate(terms))
    loss = sum(w * sums[i] / counts[i] for i, (_, w, _, _) in enumerate(terms))
    out = {name: sums[i] / counts[i] for i, (name, *_) in enumerate(terms)
           if name is not None}
    out.update({key: local[2 * k + j].to(metrics[key].dtype)
                for j, key in enumerate(counted)})
    return objective, loss, out


def _make_train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                     cfg, forward_loss: Callable, mesh=None) -> Callable:
    """The step shared by the workloads around ``forward_loss(video, batch,
    rng, **kw) -> (loss, metrics, terms)``, the workload's forward and loss
    (terms: ``_global_loss``'s).  ``mesh`` makes it a data-parallel
    process's step and sets the BatchNorms' synchronisation from
    ``cfg.mesh.sync_batchnorm``."""
    from ..parallel import running_stats, set_sync_batchnorm
    freeze = tuple(cfg.freeze_prefixes)
    crop = cfg.data.crop_size
    dtype = getattr(torch, cfg.compute_dtype)
    kernels = cfg.use_pallas_attention
    device = next(model.parameters()).device
    state = TrainState(model, optimizer, cfg.optim)
    sync_bn = mesh is not None and cfg.mesh.sync_batchnorm
    set_sync_batchnorm(model, mesh if sync_bn else None)

    def step(batch, generator: torch.Generator, marks: Optional[List] = None,
             **kw) -> Dict[str, torch.Tensor]:
        model.train()
        step.updating = False
        _mark(marks, "start")
        video = ingest_train_batch(batch, crop, dtype, kernels)
        _mark(marks, "ingest")
        rng = DropoutRNG(int(torch.randint(0, 2 ** 62, (1,), generator=generator)),
                         device, None if mesh is None else mesh.rows(video.shape[0]))
        loss, metrics, terms = forward_loss(video, batch, rng, **kw)
        objective = loss
        if mesh is not None:
            objective, loss, metrics = _global_loss(mesh, terms, metrics)
        _mark(marks, "forward")
        optimizer.zero_grad(set_to_none=True)
        objective.backward()
        if mesh is not None:
            mesh.all_reduce_grads_(model.parameters())
        freeze_grads(model, freeze)
        _mark(marks, "backward")
        step.updating = True   # for the memory guard: parameters now move
        state.apply_gradients()
        step.updating = False
        if mesh is not None and not sync_bn:
            # per-process statistics: process 0's running ones are kept
            mesh.broadcast_(running_stats(model))
        _mark(marks, "optimizer")
        return {"loss": loss.detach(), **metrics}

    step.state = state
    return step


def make_sbl_train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                        cfg, mesh=None) -> Callable:
    """``step(batch, generator, marks=None, use_gold=None) -> metrics``.

    batch: tensors on the model's device -- clip_u8 (B, T, H, W) uint8,
    labels and labels_reverse (B, P), the plans offsets/flip/frame_map,
    optional n_frames.  generator: a ``torch.Generator`` for the step's
    random numbers.  use_gold: optional injected teacher-forcing coins.
    marks: a list to receive (stage, CUDA event) pairs at the ingest,
    forward, backward and optimizer boundaries.  Returns f32 scalar tensors
    (loss, loss_l2r, loss_r2l) and counts (n_correct_l2r, n_correct_r2l),
    left on the device.  ``step.state`` is the TrainState.  ``mesh``: a
    data-parallel process's step (``_make_train_step``)."""
    smoothing = cfg.optim.label_smoothing

    def forward_loss(video, batch, rng, use_gold: Optional[Sequence[bool]] = None):
        p_l2r, g_l2r, p_r2l, g_r2l = model(video, batch["labels"],
                                           batch["labels_reverse"], rng, use_gold)
        loss_l2r, nc_l2r = cal_performance(p_l2r, g_l2r, smoothing)
        loss_r2l, nc_r2l = cal_performance(p_r2l, g_r2l, smoothing)
        return 0.5 * (loss_l2r + loss_r2l), {
            "loss_l2r": loss_l2r.detach(), "loss_r2l": loss_r2l.detach(),
            "n_correct_l2r": nc_l2r, "n_correct_r2l": nc_r2l}, [
            ("loss_l2r", 0.5, loss_l2r, token_count(g_l2r)),
            ("loss_r2l", 0.5, loss_r2l, token_count(g_r2l))]

    return _make_train_step(model, optimizer, cfg, forward_loss, mesh)


def make_uni_train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                        cfg, mesh=None) -> Callable:
    """``step(batch, generator, marks=None) -> metrics`` for a
    ``UniTransformer`` (JAX ``make_uni_train_body``): the batch of
    ``make_sbl_train_step`` without ``labels_reverse``; the teacher-forced
    forward with dropout, one label-smoothed loss.  Returns the f32 loss and
    n_correct, left on the device."""
    smoothing = cfg.optim.label_smoothing

    def forward_loss(video, batch, rng):
        pred, gold = model(video, batch["labels"], rng)
        loss, n_correct = cal_performance(pred, gold, smoothing)
        return loss, {"n_correct": n_correct}, [
            (None, 1.0, loss, token_count(gold))]

    return _make_train_step(model, optimizer, cfg, forward_loss, mesh)


def make_classify_train_step(model: torch.nn.Module,
                             optimizer: torch.optim.Optimizer, cfg,
                             mesh=None) -> Callable:
    """``step(batch, generator, marks=None) -> metrics`` for a
    ``ClassifyTransformer`` (JAX ``make_classify_train_body``): the batch
    carries word_id and lang_id (B,) instead of labels; the loss is the word
    CE plus ``cfg.language_loss_weight`` times the language CE, samples with
    a label below 0 left out.  Returns the f32 loss and the counts
    word_correct, lang_correct, left on the device."""
    lw = cfg.language_loss_weight

    def forward_loss(video, batch, rng):
        word_logits, lang_logits = model(video, rng)
        # classify_loss's terms, kept apart for the data-parallel weights
        (word_ce, n_word), (lang_ce, n_lang), w_ok, l_ok = classify_terms(
            word_logits, batch["word_id"], lang_logits, batch["lang_id"])
        return word_ce + lw * lang_ce, {
            "word_correct": w_ok, "lang_correct": l_ok}, [
            (None, 1.0, word_ce, n_word), (None, lw, lang_ce, n_lang)]

    return _make_train_step(model, optimizer, cfg, forward_loss, mesh)


def make_train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                    cfg, mesh=None) -> Callable:
    """The train step of ``cfg``'s workload (JAX ``Trainer``'s choice)."""
    make = {"classify": make_classify_train_step, "sbl": make_sbl_train_step,
            "uni": make_uni_train_step}[model_kind(cfg)]
    return make(model, optimizer, cfg, mesh)


def make_uni_eval_step(model: torch.nn.Module, cfg) -> Callable:
    """``eval_step(batch) -> ys`` for a ``UniTransformer`` (JAX
    ``make_uni_eval_step``): eval ingest, then the KV-cached greedy decode;
    ys is (B, maxlen+1) ids with the leading sos."""
    crop = cfg.data.crop_size

    def eval_step(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return recognize_batch(model, batch["clip_u8"], crop,
                               n_frames=batch.get("n_frames"))

    return eval_step


def make_classify_eval_step(model: torch.nn.Module, cfg) -> Callable:
    """``eval_step(batch) -> (word_logits, lang_logits)`` for a
    ``ClassifyTransformer`` (JAX ``make_classify_eval_step``): eval ingest
    (center crop, no flip), the model in eval mode, f32 logits (B, 1500)
    and (B, 2)."""
    crop = cfg.data.crop_size

    def eval_step(batch: Dict[str, torch.Tensor]):
        model.eval()
        with torch.inference_mode(), cast_dense_weights(model):
            video = device_ingest(batch["clip_u8"], crop, model.frontend.dtype,
                                  n_frames=batch.get("n_frames"))
            return model(video)

    return eval_step


def make_eval_step(model: torch.nn.Module, cfg) -> Optional[Callable]:
    """The eval step of ``cfg``'s workload: the classify logits, the
    unidirectional greedy decode, or None for ``sbl``, whose validation
    decodes through ``recognize_batch`` itself."""
    make = {"classify": make_classify_eval_step,
            "uni": make_uni_eval_step}.get(model_kind(cfg))
    return None if make is None else make(model, cfg)
