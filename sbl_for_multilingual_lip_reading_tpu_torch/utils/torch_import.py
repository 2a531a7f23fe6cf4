"""Reference PyTorch checkpoints into the port (counterpart of the JAX
package's ``utils/torch_import.py``).

The reference trains and saves PyTorch ``state_dict``s (frontend ``.pt``
files such as ``acc0.84412.pt``, whole ``BEST_checkpoint_*.tar`` pickles;
reference video_frontend.py:176-190, train.py:91-103).  This module maps
such a state dict, given as ``{name: np.ndarray}``, straight onto the
port's ``state_dict``: the port is PyTorch too, so Linear and Conv2d
weights keep their layout, and only these change:

* the stem ``frontend3D.0`` Conv3d (C, 1, kt, 7, 7) -> ``conv3d_weight``
  (C, kt, 7, 7), the conv2d over the kt stacked frames;
* ResNet names: ``resnet18.layer{s}.{b}`` -> ``resnet.layer{s}_block{b}``,
  ``downsample.0`` / ``downsample.1`` -> ``downsample_conv`` /
  ``downsample_bn``; the encoder's ``layer_stack.{i}`` -> ``layer_{i}``;
* SBL decoder: the reference's separate l2r and r2l stacks
  (``layer_first_*``, ``layer_stack_*.{i-1}``, ``tgt_word_prj_*``) stack
  into the port's direction axis (dir 0 = l2r); each layer's
  ``enc_attn.w_ks/w_vs`` become the hoisted ``cross_kv_{i}`` projections.

``load_torch_file`` reads a raw state dict from a ``.pt`` file.  The
reference's whole-module pickles need its classes, which this repo does
not have, so they are refused.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from ..parallel.mesh import shard_state_dict

StateDict = Dict[str, torch.Tensor]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _copy(out: StateDict, sd, src: str, dst: str,
          leaves: Sequence[str] = ("weight", "bias")) -> None:
    """dst.<leaf> = src.<leaf> for each leaf the reference has."""
    for leaf in leaves:
        if f"{src}.{leaf}" in sd:
            out[f"{dst}.{leaf}"] = _t(sd[f"{src}.{leaf}"])


def _stack(out: StateDict, sd, l2r: str, r2l: str, dst: str) -> None:
    """dst.<leaf> = stack(l2r.<leaf>, r2l.<leaf>) for weight and bias."""
    for leaf in ("weight", "bias"):
        if f"{l2r}.{leaf}" in sd:
            out[f"{dst}.{leaf}"] = torch.stack([_t(sd[f"{l2r}.{leaf}"]),
                                                _t(sd[f"{r2l}.{leaf}"])])


_BN = ("weight", "bias", "running_mean", "running_var")


def import_frontend(sd: Dict[str, np.ndarray], resnet_blocks=(2, 2, 2, 2),
                    prefix: str = "visual_frontend.") -> StateDict:
    """The reference visual frontend -> the port's ``frontend.*`` keys."""
    out: StateDict = {"frontend.conv3d_weight":
                      _t(sd[prefix + "frontend3D.0.weight"])[:, 0]}
    _copy(out, sd, prefix + "frontend3D.1", "frontend.bn3d", _BN)
    for stage, nblocks in enumerate(resnet_blocks):
        for blk in range(nblocks):
            t = f"{prefix}resnet18.layer{stage + 1}.{blk}"
            o = f"frontend.resnet.layer{stage + 1}_block{blk}"
            for conv in ("conv1", "conv2"):
                _copy(out, sd, f"{t}.{conv}", f"{o}.{conv}", ("weight",))
            for bn in ("bn1", "bn2"):
                _copy(out, sd, f"{t}.{bn}", f"{o}.{bn}", _BN)
            if f"{t}.downsample.0.weight" in sd:
                _copy(out, sd, f"{t}.downsample.0", f"{o}.downsample_conv",
                      ("weight",))
                _copy(out, sd, f"{t}.downsample.1", f"{o}.downsample_bn", _BN)
    return out


def import_encoder(sd: Dict[str, np.ndarray], n_layers: int = 6,
                   prefix: str = "encoder.") -> StateDict:
    """The reference encoder -> the port's ``encoder.*`` keys."""
    out: StateDict = {}
    _copy(out, sd, prefix + "linear_in", "encoder.linear_in")
    _copy(out, sd, prefix + "layer_norm_in", "encoder.layer_norm_in")
    for i in range(n_layers):
        t, o = f"{prefix}layer_stack.{i}", f"encoder.layer_{i}"
        for sub in ("w_qs", "w_ks", "w_vs", "fc", "layer_norm"):
            _copy(out, sd, f"{t}.slf_attn.{sub}", f"{o}.slf_attn.{sub}")
        for sub in ("w_1", "w_2", "layer_norm"):
            _copy(out, sd, f"{t}.pos_ffn.{sub}", f"{o}.pos_ffn.{sub}")
    return out


def import_sbl_decoder(sd: Dict[str, np.ndarray], n_layers: int = 6,
                       prefix: str = "decoder.") -> StateDict:
    """The reference SBL decoder's two stacks -> the port's direction-stacked
    ``decoder.*`` keys."""
    out: StateDict = {"decoder.step.tgt_word_emb.weight":
                      _t(sd[prefix + "tgt_word_emb.weight"])}
    for i in range(n_layers):
        if i == 0:
            l2r, r2l = prefix + "layer_first_l2r", prefix + "layer_first_r2l"
        else:
            l2r = f"{prefix}layer_stack_l2r.{i - 1}"
            r2l = f"{prefix}layer_stack_r2l.{i - 1}"
        o = f"decoder.step.layer_{i}"
        for sub in ("w_qs", "w_ks", "w_vs", "fc", "layer_norm"):
            _stack(out, sd, f"{l2r}.slf_attn.{sub}", f"{r2l}.slf_attn.{sub}",
                   f"{o}.slf.{sub}")
        for sub in ("w_qs", "fc", "layer_norm"):
            _stack(out, sd, f"{l2r}.enc_attn.{sub}", f"{r2l}.enc_attn.{sub}",
                   f"{o}.cross.{sub}")
        for sub in ("w_ks", "w_vs"):
            _stack(out, sd, f"{l2r}.enc_attn.{sub}", f"{r2l}.enc_attn.{sub}",
                   f"decoder.cross_kv_{i}.{sub}")
        for sub in ("w_1", "w_2", "layer_norm"):
            _stack(out, sd, f"{l2r}.pos_ffn.{sub}", f"{r2l}.pos_ffn.{sub}",
                   f"{o}.ffn.{sub}")
    # untied output heads, no bias (reference decoder.py:59-60)
    _stack(out, sd, prefix + "tgt_word_prj_l2r", prefix + "tgt_word_prj_r2l",
           "decoder.step.tgt_word_prj")
    return out


def import_sbl_model(sd: Dict[str, np.ndarray], n_enc_layers: int = 6,
                     n_dec_layers: int = 6, resnet_blocks=(2, 2, 2, 2),
                     model=None) -> StateDict:
    """A whole reference SBL Transformer state dict -> the port's
    ``state_dict`` (parameters and BN running statistics), for
    ``SBLTransformer.load_state_dict``: the whole one, or with ``model``
    (sharded by ``parallel.shard_model``) that process's slices of it."""
    out = {**import_frontend(sd, resnet_blocks),
           **import_encoder(sd, n_enc_layers),
           **import_sbl_decoder(sd, n_dec_layers)}
    return out if model is None else shard_state_dict(out, model)


def load_torch_file(path: str) -> Dict[str, np.ndarray]:
    """{name: np.ndarray} of a raw state dict saved with ``torch.save``
    (the reference's frontend ``.pt`` files), or of the ``"model"`` entry
    of a checkpoint dict when that entry is itself a state dict."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and isinstance(obj.get("model"), dict):
        obj = obj["model"]
    if not isinstance(obj, dict) or not all(
            isinstance(v, torch.Tensor) for v in obj.values()):
        raise ValueError(f"{path}: not a raw state dict (a pickled module "
                         f"needs the reference's classes)")
    return {k: v.detach().cpu().numpy() for k, v in obj.items()}
