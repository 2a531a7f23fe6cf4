"""The SBL train step (counterpart of the JAX package's
``training/steps.py::make_sbl_train_body``):

    uint8 clips + plans -> train ingest -> frontend (batch-statistics BN)
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

from typing import Callable, Dict, List, Optional, Sequence

import torch

from ..data.ingest import device_ingest
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


def ingest_train(batch: Dict[str, torch.Tensor], crop: int,
                 dtype: torch.dtype) -> torch.Tensor:
    """The train branch of ``device_ingest`` on a batch with plans."""
    return device_ingest(batch["clip_u8"], crop, dtype,
                         n_frames=batch.get("n_frames"),
                         **{k: batch[k] for k in PLAN_KEYS})


def expected_launches(cfg) -> Dict[str, int]:
    """Kernel launches one train step makes on the kernel path: K2 once;
    K3 once per encoder layer and per decoder layer, attention and decode
    step, and once more for each decoder call in the checkpoint's
    recompute; K4 once per K3 of the forward; no K1 or K5."""
    enc = cfg.dims.n_enc_layers
    dec = 2 * cfg.decoder.maxlen * cfg.dims.n_dec_layers
    return {"small_mha_flat": 0, "stack_frames": 1,
            "small_mha_dropout_fwd_flat": enc + dec * (2 if cfg.remat_decoder else 1),
            "small_mha_dropout_bwd_flat": enc + dec,
            "dropout_keep_mask_flat": 0}


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
    device = next(model.parameters()).device
    state = TrainState(model, optimizer, cfg.optim)

    def step(batch, generator: torch.Generator,
             use_gold: Optional[Sequence[bool]] = None,
             marks: Optional[List] = None) -> Dict[str, torch.Tensor]:
        model.train()
        _mark(marks, "start")
        video = ingest_train(batch, crop, dtype)
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
