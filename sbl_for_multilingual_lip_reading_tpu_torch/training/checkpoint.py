"""Checkpoints of the train state, and the shape-filtered partial load of
the three-stage transfer (counterpart of the JAX package's
``training/checkpoint.py``, which writes orbax array checkpoints).

A checkpoint is a directory holding one ``torch.save`` file of {the model's
``state_dict`` (parameters and BN running statistics), the optimizer's
state, the update count, epoch, best_metric, and the trainer's random
number states}; with ``is_best`` it is mirrored to ``<path>_best/``, as in
JAX.  The random number states (the plan ``np.random.Generator`` and the
step ``torch.Generator``) make a resumed run draw what an uninterrupted one
draws; the JAX checkpoint does not keep them.  Files are written under a
temporary name and renamed into place, so a cut-off save never leaves a
checkpoint that looks whole.

``restore_for_transfer`` takes the JAX package's ``/``-joined prefixes
("encoder", "decoder/step/layer_0"): the port names its modules after the
JAX ones, so a prefix maps onto the port's module path component by
component.
"""
from __future__ import annotations

import os
import shutil
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .state import TrainState

FILE = "checkpoint.pt"


def _write(payload: Dict, path: str) -> None:
    os.makedirs(path, exist_ok=True)
    target = os.path.join(path, FILE)
    tmp = target + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, target)


def save_checkpoint(path: str, state: TrainState, epoch: int = 0,
                    best_metric: float = float("inf"), is_best: bool = False,
                    rng_state: Optional[Dict] = None) -> None:
    """Save to ``<path>/`` (and mirror to ``<path>_best/`` when is_best)."""
    payload = {"model": state.model.state_dict(),
               "optimizer": state.optimizer.state_dict(),
               "step": int(state.step), "epoch": int(epoch),
               "best_metric": float(best_metric),
               "rng_state": rng_state or {}}
    _write(payload, path)
    if is_best:
        best = os.path.abspath(path) + "_best"
        os.makedirs(best, exist_ok=True)
        tmp = os.path.join(best, FILE + ".tmp")
        shutil.copyfile(os.path.join(path, FILE), tmp)
        os.replace(tmp, os.path.join(best, FILE))


def load(path: str) -> Dict:
    """The payload of the checkpoint in ``path/``, tensors on the CPU."""
    return torch.load(os.path.join(path, FILE), map_location="cpu",
                      weights_only=True)


def restore_checkpoint(path: str, state: TrainState
                       ) -> Tuple[TrainState, int, float, Dict]:
    """Full restore into ``state`` (model, optimizer moments and the update
    count, so the Noam lr carries on).  Returns (state, epoch, best_metric,
    rng_state)."""
    payload = load(path)
    state.model.load_state_dict(payload["model"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    return (state, int(payload["epoch"]), float(payload["best_metric"]),
            payload.get("rng_state", {}))


def partial_merge(fresh: Dict[str, torch.Tensor],
                  pretrained: Dict[str, torch.Tensor]
                  ) -> Tuple[Dict[str, torch.Tensor], List[str], List[str]]:
    """Take each pretrained entry whose key AND shape match a fresh one
    (the reference's filtered state-dict update, train.py:96-103).
    Returns (merged, loaded keys, missed keys)."""
    merged, loaded, missed = {}, [], []
    for k, v in fresh.items():
        pv = pretrained.get(k)
        if pv is not None and tuple(pv.shape) == tuple(v.shape):
            merged[k] = pv
            loaded.append(k)
        else:
            merged[k] = v
            missed.append(k)
    return merged, loaded, missed


def restore_for_transfer(path: str, model: torch.nn.Module,
                         load_prefixes: Optional[Sequence[str]] = None
                         ) -> List[str]:
    """Partial restore: merge the key+shape intersection of a checkpoint's
    model into ``model`` (parameters and BN statistics) and return the keys
    loaded.  The caller rebuilds the optimizer, as JAX's caller does and as
    the reference does after a transfer load (train.py:106-109).

    load_prefixes: optional JAX-style prefixes restricting the merge; each
    must match the leading components of a key: "encoder" keeps the whole
    encoder, "decoder/step/layer_0" just that layer."""
    pretrained = load(path)["model"]
    if load_prefixes is not None:
        prefixes = [tuple(str(p).strip("/").split("/")) for p in load_prefixes]
        pretrained = {k: v for k, v in pretrained.items()
                      if any(tuple(k.split(".")[:len(p)]) == p
                             for p in prefixes)}
    merged, loaded, _ = partial_merge(model.state_dict(), pretrained)
    model.load_state_dict(merged)
    return loaded
