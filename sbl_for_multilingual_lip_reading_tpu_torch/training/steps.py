"""The SBL train step (counterpart of the JAX package's
``training/steps.py::make_sbl_train_body``):

    uint8 clips + plans -> train ingest (K6 under PALLAS_INGEST)
    -> frontend (batch-statistics BN; K7/K8 under PALLAS_BN)
    -> encoder -> teacher-forced bidirectional decode, with dropout
    -> loss 0.5 * (l2r + r2l), label smoothing -> backward
    -> frozen subtrees' gradients zeroed -> Adam with the Noam lr

The BN running statistics update inside the forward.  Frozen subtrees
(``cfg.freeze_prefixes``) get ZERO gradients, not None, as JAX's
``_freeze_grads`` gives them: Adam's moments then keep moving those weights,
as they do under optax (``torch.optim.Adam`` would skip a None gradient).

The step's random numbers come from the ``torch.Generator`` the caller
passes (a CPU one: drawing from it never waits for the device): one seed per
step builds the forward's ``DropoutRNG``.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Sequence

import torch

from ..data.ingest import device_ingest
from ..models.frontend import pallas_bn_on
from ..ops.ingest import MAX_OFFSET, ingest_train, ingest_train_plain
from ..models.layers import DropoutRNG
from .loss import cal_performance
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
    """Kernel launches one train step makes on the kernel path: K2 once;
    K3 once per encoder layer and per decoder layer, attention and decode
    step, and once more for each decoder call in the checkpoint's
    recompute; K4 once per K3 of the forward; no K1 or K5; K6 once under
    ``PALLAS_INGEST``; K7 once per frontend BatchNorm in the forward and K8
    once per BatchNorm in the backward under ``PALLAS_BN`` (as the
    environment stands when this is called)."""
    enc = cfg.dims.n_enc_layers
    dec = 2 * cfg.decoder.maxlen * cfg.dims.n_dec_layers
    bns = frontend_bn_count(cfg.frontend) if pallas_bn_on(False) else 0
    return {"stack_frames_u8": 0, "fused_resblock": 0, "fused_decoder_layer": 0,
            "small_mha_flat": 0, "stack_frames": 1,
            "small_mha_dropout_fwd_flat": enc + dec * (2 if cfg.remat_decoder else 1),
            "small_mha_dropout_bwd_flat": enc + dec,
            "dropout_keep_mask_flat": 0,
            "ingest_train": int(kernel_ingest_on(cfg.data.raw_size,
                                                 cfg.data.crop_size)),
            "channel_sums": bns, "channel_sums_pair": bns}


def _mark(marks: Optional[List], name: str) -> None:
    if marks is not None:
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        marks.append((name, event))


def make_sbl_train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                        cfg) -> Callable:
    """``step(batch, generator, use_gold=None, marks=None) -> metrics``.

    batch: tensors on the model's device -- clip_u8 (B, T, H, W) uint8,
    labels and labels_reverse (B, P), the plans offsets/flip/frame_map,
    optional n_frames.  generator: a ``torch.Generator`` for the step's
    random numbers.  use_gold: optional injected teacher-forcing coins.
    marks: a list to receive (stage, CUDA event) pairs at the ingest,
    forward, backward and optimizer boundaries.  Returns f32 scalar tensors
    (loss, loss_l2r, loss_r2l) and counts (n_correct_l2r, n_correct_r2l),
    left on the device.  ``step.state`` is the TrainState."""
    freeze = tuple(cfg.freeze_prefixes)
    crop = cfg.data.crop_size
    dtype = getattr(torch, cfg.compute_dtype)
    smoothing = cfg.optim.label_smoothing
    kernels = cfg.use_pallas_attention
    device = next(model.parameters()).device
    state = TrainState(model, optimizer, cfg.optim)

    def step(batch, generator: torch.Generator,
             use_gold: Optional[Sequence[bool]] = None,
             marks: Optional[List] = None) -> Dict[str, torch.Tensor]:
        model.train()
        _mark(marks, "start")
        video = ingest_train_batch(batch, crop, dtype, kernels)
        _mark(marks, "ingest")
        rng = DropoutRNG(int(torch.randint(0, 2 ** 62, (1,), generator=generator)),
                         device)
        p_l2r, g_l2r, p_r2l, g_r2l = model(video, batch["labels"],
                                           batch["labels_reverse"], rng, use_gold)
        loss_l2r, nc_l2r = cal_performance(p_l2r, g_l2r, smoothing)
        loss_r2l, nc_r2l = cal_performance(p_r2l, g_r2l, smoothing)
        loss = 0.5 * (loss_l2r + loss_r2l)
        _mark(marks, "forward")
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        freeze_grads(model, freeze)
        _mark(marks, "backward")
        state.apply_gradients()
        _mark(marks, "optimizer")
        return {"loss": loss.detach(), "loss_l2r": loss_l2r.detach(),
                "loss_r2l": loss_r2l.detach(), "n_correct_l2r": nc_l2r,
                "n_correct_r2l": nc_r2l}

    step.state = state
    return step


def make_uni_eval_step(model: torch.nn.Module, cfg) -> Callable:
    """``eval_step(batch) -> ys`` for a ``UniTransformer`` (JAX
    ``make_uni_eval_step``): eval ingest, then the KV-cached greedy decode;
    ys is (B, maxlen+1) ids with the leading sos."""
    from ..recognize import recognize_batch
    crop = cfg.data.crop_size

    def eval_step(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return recognize_batch(model, batch["clip_u8"], crop,
                               n_frames=batch.get("n_frames"))

    return eval_step
