"""The reference's staged training recipe as one scripted pipeline
(counterpart of the JAX package's ``training/recipe.py``).

Reference README.md:46-68 describes the three-stage protocol:

* Stage 1: pretrain the visual frontend + encoder with the 1500-class word
  classification task (``classify``).
* Stage 2: transfer that frontend and encoder into the SBL model, FREEZE
  them (``p.requires_grad = False``), and train the decoder, first with
  teacher forcing 0.5, then annealed to 0.1.
* Stage 3: unfreeze everything and finetune at teacher forcing 0.5.

The reference runs these as four manual ``train.py`` invocations with code
edits in between; here each stage is a fresh ``Trainer`` (a fresh optimizer
and Noam schedule, as each reference run restarts them) whose weights come
through the checkpoint transfer the CLI uses (``--transfer-from``,
``checkpoint.restore_for_transfer``).  Frozen subtrees get zero gradients,
so a fresh Adam leaves them bit for bit where the stage found them.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

from . import checkpoint as ckpt
from .trainer import Trainer


def _stage_cfg(sbl_cfg, teacher_forcing: float, freeze: tuple):
    return dataclasses.replace(
        sbl_cfg,
        decoder=dataclasses.replace(sbl_cfg.decoder,
                                    teacher_forcing_rate=teacher_forcing),
        freeze_prefixes=freeze)


def run_three_stage_recipe(classify_cfg, sbl_cfg, classify_ds, sbl_ds,
                           eval_ds, workdir: str,
                           classify_steps: int = 50,
                           stage_steps: int = 100,
                           epochs_per_stage: int = 1,
                           max_eval_batches: Optional[int] = None,
                           stage_epochs: Optional[Dict[str, int]] = None,
                           finetune_cfg=None, logger=None,
                           device=None) -> List[Dict]:
    """Run classify -> transfer -> sbl (tf .5, frozen) -> sbl (tf .1,
    frozen) -> sbl finetune (tf .5) on ``device`` (the card unless told
    otherwise).  Returns one record per stage, most recent last, with the
    keys of JAX's: ``stage`` and the last epoch's mean ``loss``; for the SBL
    stages also ``wer`` (the greedy eval WER after the stage, l2r and r2l
    halved), ``metrics``, ``transferred`` (the parameter tensors merged from
    the previous stage's checkpoint; JAX counts its params leaves, and its
    batch statistics merge beside them) and ``path``.

    steps are per-epoch caps (``max_steps_per_epoch``); datasets follow the
    Trainer contract; checkpoints land under ``workdir/<stage>``.
    stage_epochs: optional per-stage epoch counts keyed by stage name.
    finetune_cfg: optional config for stage 3 (e.g. a gentler lr: at small
    scale the Noam restart can wreck what stage 2 learnt)."""
    records: List[Dict] = []

    def log(msg):
        if logger is not None:
            logger.info(msg)

    def n_epochs(name):
        return (stage_epochs or {}).get(name, epochs_per_stage)

    # ---- stage 1: classify pretrain (frontend + encoder)
    tr_c = Trainer(classify_cfg, classify_ds, device=device)
    for e in range(n_epochs("classify")):
        loss = tr_c.train_epoch(e, max_steps=classify_steps)
    p1 = os.path.join(workdir, "stage1_classify")
    ckpt.save_checkpoint(p1, tr_c.state)
    records.append({"stage": "classify", "loss": loss})
    log(f"stage 1 (classify) done: loss {loss:.3f}")
    del tr_c

    def sbl_stage(name, prev_path, teacher_forcing, freeze, steps,
                  base_cfg=None):
        cfg = _stage_cfg(base_cfg or sbl_cfg, teacher_forcing, freeze)
        tr = Trainer(cfg, sbl_ds, device=device)
        params = {n for n, _ in tr.model.named_parameters()}
        loaded = [k for k in ckpt.restore_for_transfer(prev_path, tr.model)
                  if k in params]
        for e in range(n_epochs(name)):
            loss = tr.train_epoch(e, max_steps=steps)
        out = tr.validate_seq2seq(eval_ds, max_batches=max_eval_batches)
        path = os.path.join(workdir, name)
        ckpt.save_checkpoint(path, tr.state)
        wer = 0.5 * (out["l2r_wer"] + out["r2l_wer"])
        records.append({"stage": name, "loss": loss, "wer": wer,
                        "metrics": out, "transferred": len(loaded),
                        "path": path})
        log(f"{name}: loss {loss:.3f} wer {wer:.3f} "
            f"({len(loaded)} params transferred)")
        return path

    # ---- stage 2: frozen frontend and encoder, the decoder learns
    frozen = ("frontend", "encoder")
    p2a = sbl_stage("stage2_tf05_frozen", p1, 0.5, frozen, stage_steps)
    p2b = sbl_stage("stage2_tf01_frozen", p2a, 0.1, frozen, stage_steps)
    # ---- stage 3: full finetune
    sbl_stage("stage3_finetune", p2b, 0.5, (), stage_steps,
              base_cfg=finetune_cfg)
    return records
