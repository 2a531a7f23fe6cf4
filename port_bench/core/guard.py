"""The import guard: the benchmark measures the PyTorch port, so no module
of JAX, of flax or of the JAX package may be loaded in the process that
prints a result.  Names are compared by their top-level part (before the
first dot), whole: the port's package name begins with the JAX package's
name and is allowed."""
from __future__ import annotations

import sys
from typing import Iterable, List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "sbl_for_multilingual_lip_reading_tpu")


def forbidden_loaded(modules: Optional[Iterable[str]] = None) -> List[str]:
    """The forbidden top-level names among ``modules`` (default: every
    module loaded in this process), sorted."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))
