"""Carry the JAX package's variables into the port's ``state_dict``.

The inverse direction of the JAX package's ``utils/torch_import.py``.  The
port names its modules after the JAX modules, so a JAX variable path maps to
a port key by joining the path with dots and renaming the leaf:

* Dense ``kernel`` (in, out) -> ``weight`` (out, in); a direction-stacked
  kernel (2, in, out) -> (2, out, in) (decoder, dir 0 = l2r, kept on axis 0);
  the classify heads map so too (``fc_word/kernel`` -> ``fc_word.weight``,
  ``fc_lang/kernel`` -> ``fc_lang.weight``);
* Conv ``kernel`` HWIO -> ``weight`` OIHW;
* ``conv3d_kernel`` (kt, 7, 7, 1, C) -> ``conv3d_weight`` (C, kt, 7, 7), the
  stem's conv2d weight over the kt stacked frames;
* LayerNorm / BatchNorm ``scale`` -> ``weight``, ``bias`` -> ``bias``;
  Embed ``embedding`` -> ``weight``;
* batch_stats ``mean`` / ``var`` -> ``running_mean`` / ``running_var``.

Takes nested dicts of numpy arrays (``jax.device_get`` of the variables);
needs no JAX.
"""
from __future__ import annotations

from typing import Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

_RENAME = {"scale": "weight", "embedding": "weight", "bias": "bias"}


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    # JAX hands out read-only buffers; torch wants writable memory
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def _param(path: Tuple[str, ...], t: torch.Tensor):
    *mods, leaf = path
    if leaf == "conv3d_kernel":
        return mods + ["conv3d_weight"], t[:, :, :, 0, :].permute(3, 0, 1, 2)
    if leaf == "kernel":
        if t.dim() == 4:                       # conv HWIO -> OIHW
            return mods + ["weight"], t.permute(3, 2, 0, 1)
        if t.dim() == 3:                       # direction-stacked dense
            return mods + ["weight"], t.transpose(1, 2)
        return mods + ["weight"], t.t()
    if leaf in _RENAME:
        return mods + [_RENAME[leaf]], t
    raise KeyError(f"unknown JAX parameter {'/'.join(path)}")


def state_dict_from_jax(params: Mapping,
                        batch_stats: Optional[Mapping] = None
                        ) -> Dict[str, torch.Tensor]:
    """JAX ``params`` (+ ``batch_stats``) trees -> the port's state_dict.
    Values may be views; ``load_state_dict`` copies them into place."""
    sd: Dict[str, torch.Tensor] = {}
    for path, a in _flatten(params):
        mods, t = _param(path, _tensor(a))
        sd[".".join(mods)] = t
    for path, a in _flatten(batch_stats or {}):
        *mods, leaf = path
        if leaf not in ("mean", "var"):
            raise KeyError(f"unknown JAX batch stat {'/'.join(path)}")
        sd[".".join(mods + ["running_" + leaf])] = _tensor(a)
    return sd
