"""Command-line entry points of the port: the reference's train.py / test.py
surface (counterpart of the JAX package's ``cli.py``, with the same flags).
``train`` and ``test`` take every workload: ``sbl`` / ``sbl_stage2``,
``lrw``, ``lrw1000`` and ``classify``.  ``test`` decodes the seq2seq
workloads greedily or with ``--beam-size K`` (``--bigram-lm`` biases the
unidirectional beam with a bigram table built from the TRAIN split, the
LRW-1000 protocol; ``sbl`` uses the paired bidirectional beam), and scores
``classify`` by word and language accuracy.

    python -m sbl_for_multilingual_lip_reading_tpu_torch.cli train [flags]
    python -m sbl_for_multilingual_lip_reading_tpu_torch.cli test --checkpoint DIR [flags]

It runs on the card; ``--cpu`` runs it on the CPU, and without a card and
without ``--cpu`` it refuses.  ``--synthetic`` (or no dataset path) uses the
synthetic dataset.  ``--mesh-model`` > 1 (tensor parallelism) is not ported
and raises, naming its ROADMAP item; ``--compile-cache`` is XLA's and is
accepted and ignored.  ``PALLAS_INGEST=1`` and ``PALLAS_BN=1`` in the
environment turn on the kernel ingest (K6) and the kernel BatchNorm
statistics (K7, K8), as in JAX.

``train --mesh-data W`` trains data-parallel on W cards, one process each
(NCCL; ``--cpu``: W processes on the CPU over gloo): under torchrun
(``torchrun --nproc_per_node W -m ...cli train --mesh-data W ...``) each
process joins the group torchrun describes; started alone, the command
starts the W processes itself on a free localhost port.  The batch size is
global.  ``--no-sync-batchnorm`` keeps BatchNorm statistics per process.
``--profile-dir D`` writes a Chrome trace of steps 1-3 into D and
``--tensorboard-dir`` logs the scalars JAX logs.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import Dict, Optional

from . import config as C

WORKLOADS = ("sbl", "sbl_stage2", "lrw", "lrw1000", "classify")
def build_argparser() -> argparse.ArgumentParser:
    """The JAX CLI's flags, so one argv configures either package."""
    p = argparse.ArgumentParser(description="SBL multilingual lip reading "
                                            "(PyTorch/CUDA)")
    p.add_argument("--workload", default="sbl", choices=WORKLOADS)
    # network architecture (reference utils.py:91-116)
    p.add_argument("--n_layers_enc", type=int, default=None)
    p.add_argument("--n_layers_dec", type=int, default=None)
    p.add_argument("--n_head", type=int, default=None)
    p.add_argument("--d_model", type=int, default=None)
    p.add_argument("--d_inner", type=int, default=None)
    p.add_argument("--dropout", type=float, default=None)
    p.add_argument("--pe_maxlen", type=int, default=None)
    p.add_argument("--label_smoothing", type=float, default=None)
    # training (reference utils.py:118-146)
    p.add_argument("--epochs", type=int, default=10000)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--k", type=float, default=None, help="Noam lr scale")
    p.add_argument("--warmup_steps", type=int, default=None)
    p.add_argument("--teacher_forcing_rate", type=float, default=None)
    p.add_argument("--checkpoint", type=str, default=None,
                   help="checkpoint dir to resume/eval from")
    p.add_argument("--transfer-from", type=str, default=None,
                   help="partial-load (path+shape filtered) from this "
                        "checkpoint, e.g. stage 1 -> stage 2")
    p.add_argument("--save-dir", type=str, default="checkpoints/run")
    # data
    p.add_argument("--synthetic", action="store_true",
                   help="use the synthetic dataset (no LRW/LRW-1000 needed)")
    p.add_argument("--synthetic-size", type=int, default=256)
    p.add_argument("--lrw-path", type=str, default=None)
    p.add_argument("--lrw1000-images", type=str, default=None)
    p.add_argument("--lrw1000-manifest", type=str, default=None,
                   help="TRAIN manifest (trn1.txt-style; also the bigram-LM "
                        "corpus)")
    p.add_argument("--lrw1000-eval-manifest", type=str, default=None,
                   help="eval manifest (val1.txt for training-time "
                        "validation, tst1.txt for test)")
    p.add_argument("--secondary-batch-size", type=int, default=None,
                   help="fixed LRW-1000 samples per batch "
                        "(TwoStreamBatchSampler)")
    p.add_argument("--profile-dir", type=str, default=None,
                   help="write a torch.profiler Chrome trace of steps 1-3 of "
                        "the first epoch into this directory")
    p.add_argument("--tensorboard-dir", type=str, default=None,
                   help="log train/loss and the validation metrics here "
                        "(TensorBoard events, or metrics.jsonl without "
                        "tensorboard)")
    p.add_argument("--cache-on-device", action="store_true",
                   help="upload the whole training set to the card once and "
                        "gather batches there by index (for datasets that "
                        "fit)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (by default the port runs on the "
                        "card, and refuses to run without one)")
    p.add_argument("--data-fraction", type=float, default=None,
                   help="reference config.py `p`")
    # parallelism: --mesh-data processes, one card each (tensor parallelism,
    # --mesh-model > 1, is not ported)
    p.add_argument("--mesh-data", type=int, default=1,
                   help="data-parallel processes, one card each; the batch "
                        "size stays global")
    p.add_argument("--mesh-model", type=int, default=1)
    p.add_argument("--no-sync-batchnorm", action="store_true",
                   help="BatchNorm statistics per process (process 0's "
                        "running statistics kept) instead of over the "
                        "global batch")
    p.add_argument("--compute-dtype", type=str, default=None)
    p.add_argument("--max-steps-per-epoch", type=int, default=None)
    p.add_argument("--max-eval-batches", type=int, default=None)
    p.add_argument("--beam-size", type=int, default=None,
                   help="beam search width for eval (default: greedy); "
                        "sbl uses the paired bidirectional beam, "
                        "unidirectional workloads the standard one")
    p.add_argument("--freeze", type=str, default=None,
                   help="comma-separated param subtrees to freeze, e.g. "
                        "'frontend,encoder' (reference requires_grad stages)")
    p.add_argument("--bigram-lm", action="store_true",
                   help="bias beam search with a bigram LM built from the "
                        "train labels (LRW-1000 protocol)")
    p.add_argument("--remat-frontend", default=None,
                   action=argparse.BooleanOptionalAction,
                   help="recompute the frontend's ResNet blocks in the "
                        "backward (on by default with --cache-on-device)")
    p.add_argument("--compile-cache", type=str, default=None,
                   help="XLA's persistent compilation cache in the JAX "
                        "package; accepted and ignored here (the CUDA "
                        "kernels build once per checkout into _build/)")
    return p


def check_ported(args) -> None:
    """Raise for a flag whose path the port does not have."""
    if args.mesh_model > 1:
        from .parallel import TENSOR_PARALLEL
        raise NotImplementedError(
            f"--mesh-model > 1 is not ported yet: {TENSOR_PARALLEL}")


def config_from_args(args) -> C.WorkloadConfig:
    """The preset of ``--workload`` with the flags' overrides (JAX
    ``config_from_args``, for the fields the port has)."""
    cfg = C.PRESETS[args.workload]()
    dims = cfg.dims
    dim_over = {}
    for field, flag in [("n_enc_layers", "n_layers_enc"),
                        ("n_dec_layers", "n_layers_dec"),
                        ("n_head", "n_head"), ("d_model", "d_model"),
                        ("d_inner", "d_inner"), ("dropout", "dropout"),
                        ("pe_maxlen", "pe_maxlen")]:
        v = getattr(args, flag)
        if v is not None:
            dim_over[field] = v
    if dim_over:
        if "d_model" in dim_over:
            d = dim_over["d_model"]
            dim_over.setdefault("d_k", d // dims.n_head)
            dim_over.setdefault("d_v", d // dims.n_head)
        dims = dataclasses.replace(dims, **dim_over)
    opt_over = {}
    if args.label_smoothing is not None:
        opt_over["label_smoothing"] = args.label_smoothing
    if args.k is not None:
        opt_over["k"] = args.k
    if args.warmup_steps is not None:
        opt_over["warmup_steps"] = args.warmup_steps
    optim = dataclasses.replace(cfg.optim, **opt_over)
    decoder = cfg.decoder
    if decoder is not None and args.teacher_forcing_rate is not None:
        decoder = dataclasses.replace(
            decoder, teacher_forcing_rate=args.teacher_forcing_rate)
    data_over = {}
    if args.lrw_path:
        data_over["lrw_path"] = args.lrw_path
    if args.lrw1000_images:
        data_over["lrw1000_images"] = args.lrw1000_images
    if args.data_fraction is not None:
        data_over["data_fraction"] = args.data_fraction
    data = dataclasses.replace(cfg.data, **data_over)
    over = dict(dims=dims, optim=optim, decoder=decoder, data=data,
                mesh=C.MeshConfig(data=args.mesh_data, model=args.mesh_model,
                                  sync_batchnorm=not args.no_sync_batchnorm))
    if args.secondary_batch_size is not None:
        over["secondary_batch_size"] = args.secondary_batch_size
    if args.freeze:
        over["freeze_prefixes"] = tuple(
            s.strip() for s in args.freeze.split(",") if s.strip())
    if args.batch_size is not None:
        over["batch_size"] = args.batch_size
    if args.compute_dtype is not None:
        over["compute_dtype"] = args.compute_dtype
    if args.remat_frontend is not None:
        over["remat_frontend"] = args.remat_frontend
    elif args.cache_on_device:
        # a device-resident dataset shares the card's memory with the
        # activations: keep the memory-saving setting unless told otherwise
        over["remat_frontend"] = True
    return dataclasses.replace(cfg, **over)


def make_datasets(cfg, args, eval_split: str = "val"):
    """(train dataset, {name: eval dataset}).  The train dataset comes from
    the train split or manifest; the eval datasets follow ``eval_split``
    (the reference trains against the val splits and ``test.py`` evaluates
    the test split and an LRW-1000 tst1.txt manifest)."""
    from .data import SyntheticLipDataset
    vocab = cfg.name if cfg.name in ("lrw", "lrw1000") else "sbl"
    if args.synthetic or not (args.lrw_path or args.lrw1000_manifest):
        kind = {"sbl": "all", "classify": "all", "lrw": "lrw",
                "lrw1000": "lrw1000"}[cfg.name]
        train = SyntheticLipDataset(size=args.synthetic_size,
                                    frames=cfg.data.frames,
                                    raw_size=cfg.data.raw_size, kind=kind,
                                    vocab=vocab)
        # seeds keyed off the split, so val and test sets are disjoint
        seed0 = 1 if eval_split == "val" else 3
        size = max(args.synthetic_size // 4, 4)
        valid = {name: SyntheticLipDataset(
            size=size, frames=cfg.data.frames, raw_size=cfg.data.raw_size,
            kind=name, vocab=vocab, seed=seed0 + i)
            for i, name in enumerate(("lrw", "lrw1000"))
            if kind in ("all", name)}
        return train, valid
    from .data import Lrw1000Dataset, LrwDataset, MixedBilingualDataset
    parts, valid = [], {}
    if args.lrw_path:
        parts.append(LrwDataset(args.lrw_path, "train", frames=cfg.data.frames,
                                data_fraction=cfg.data.data_fraction,
                                vocab=vocab))
        valid["lrw"] = LrwDataset(args.lrw_path, eval_split,
                                  frames=cfg.data.frames, vocab=vocab)
    if args.lrw1000_manifest:
        parts.append(Lrw1000Dataset(args.lrw1000_images, args.lrw1000_manifest,
                                    frames=cfg.data.frames,
                                    raw_size=cfg.data.raw_size, vocab=vocab))
    if args.lrw1000_eval_manifest:
        valid["lrw1000"] = Lrw1000Dataset(args.lrw1000_images,
                                          args.lrw1000_eval_manifest,
                                          frames=cfg.data.frames,
                                          raw_size=cfg.data.raw_size,
                                          vocab=vocab)
    train = parts[0] if len(parts) == 1 else MixedBilingualDataset(*parts)
    return train, valid


def _setup(argv):
    args = build_argparser().parse_args(argv)
    check_ported(args)
    from .utils.device import resolve_device
    device = resolve_device("cpu" if args.cpu else None)
    return args, config_from_args(args), device


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _train_process(rank: int, argv, world: int, port: int) -> None:
    """One process of a data-parallel ``train`` started by ``run_train``."""
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    run_train(argv)


def run_train(argv=None):
    """``train``: fit for ``--epochs``, checkpointing to ``--save-dir``
    (and ``<save-dir>_best``).  ``--transfer-from`` merges a checkpoint's
    matching weights into the fresh model and starts a fresh optimizer;
    ``--checkpoint`` resumes (model, optimizer, update count, random
    number states) at the epoch after the saved one.  Returns the
    ``Trainer`` and the last epoch's results (``Trainer.fit``).  With
    ``--mesh-data W`` > 1 and no RANK in the environment it starts W
    processes, waits for them and returns (None, None)."""
    args, cfg, device = _setup(argv)
    if cfg.mesh.data > 1 and "RANK" not in os.environ:
        import torch.multiprocessing as mp
        mp.start_processes(_train_process, nprocs=cfg.mesh.data,
                           args=(argv, cfg.mesh.data, _free_port()),
                           start_method="spawn")
        return None, None
    from .training import checkpoint as ckpt
    from .training.trainer import Trainer
    train_ds, valid_ds = make_datasets(cfg, args)
    mesh = None
    if cfg.mesh.data > 1:
        from .parallel import make_mesh
        # each process on its own card (LOCAL_RANK), or on the CPU
        mesh = make_mesh(cfg.mesh.data, cfg.mesh.model,
                         "cpu" if args.cpu else None)
    tr = Trainer(cfg, train_ds, valid_ds, checkpoint_dir=args.save_dir,
                 device=device, cache_on_device=args.cache_on_device,
                 mesh=mesh, tensorboard_dir=args.tensorboard_dir,
                 profile_dir=args.profile_dir)
    start = 0
    if args.transfer_from:
        loaded = ckpt.restore_for_transfer(args.transfer_from, tr.model)
        tr.logger.info(f"transfer: loaded {len(loaded)}/"
                       f"{len(tr.model.state_dict())} tensors")
        tr.reset_optimizer()
    elif args.checkpoint and os.path.isdir(args.checkpoint):
        start = tr.restore(args.checkpoint) + 1
    out = tr.fit(args.epochs, max_steps_per_epoch=args.max_steps_per_epoch,
                 max_eval_batches=args.max_eval_batches, start_epoch=start)
    if tr.writer is not None:
        tr.writer.close()
    if mesh is not None:
        from .parallel import shutdown
        shutdown()
    return tr, out


def run_test(argv=None) -> Dict[str, Dict[str, float]]:
    """``test``: load ``--checkpoint``, evaluate the test split of every
    eval set (greedy, or beam search with ``--beam-size``), print and return
    {name: WER/PER, per direction for ``sbl``}; for ``classify`` {name:
    word_acc, lang_acc}."""
    args, cfg, device = _setup(argv)
    import numpy as np
    from .models import build_model
    from .training import checkpoint as ckpt
    from .training.trainer import Trainer
    train_ds, valid_ds = make_datasets(cfg, args, eval_split="test")
    model = build_model(cfg, device)
    if args.checkpoint:
        model.load_state_dict(ckpt.load(args.checkpoint)["model"])
    tr = Trainer(cfg, [], valid_ds, model=model)
    bigram_logp = None
    if args.bigram_lm and C.model_kind(cfg) == "uni":
        from .decode import bigram_from_dataset
        # the reference's table is a TRAIN-corpus one; make_datasets always
        # builds train_ds from the train split, so no test label leaks into
        # the eval LM
        big = bigram_from_dataset(train_ds, cfg.decoder.vocab_size)
        bigram_logp = np.log(big + np.float32(1e-10))
    out = {}
    for name, ds in valid_ds.items():
        out[name] = tr.validate(ds, args.max_eval_batches,
                                beam_size=args.beam_size,
                                bigram_logp=bigram_logp)
        print(name, out[name])
    return out


def main(argv: Optional[list] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    commands = {"train": run_train, "test": run_test}
    if not argv or argv[0] not in commands:
        print(f"usage: python -m {__package__}.cli {{train,test}} [flags]; "
              f"--help after the command lists the flags", file=sys.stderr)
        return 2
    commands[argv[0]](argv[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
