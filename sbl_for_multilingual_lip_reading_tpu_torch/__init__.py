"""PyTorch/CUDA port of the SBL lip-reading framework, for one NVIDIA H100.

Beside the JAX package ``sbl_for_multilingual_lip_reading_tpu``, which stays
the reference.  Each TPU (Pallas) kernel on a ported path becomes a
hand-written CUDA kernel for Hopper (``csrc/``, built at first use by
``ops/_build.py``), kept beside its plain PyTorch version.  Module names
follow the JAX package.  This package imports ``torch`` and never ``jax``,
``flax`` or the JAX package: it carries its own copies of the config fields
and vocabulary it reads (``config``, ``vocab``), checked against the JAX
package's by the tests.

Ported so far: the ``sbl``/``sbl_stage2`` workloads' recognize path
(``recognize.recognize_batch``), train step, and training entry point
(``python -m sbl_for_multilingual_lip_reading_tpu_torch.cli train|test``,
``training.trainer.Trainer``).  Entry points run on the card unless the
caller asks for the CPU.
"""
