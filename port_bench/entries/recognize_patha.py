"""Entry ``recognize_patha``: ``recognize.recognize_batch`` as the entry
``recognize`` drives it, with both evaluation-side switches on, the port's
fastest eval path (path A): ``cfg.use_fused_decoder_layer`` (K11 takes each
SBL decoder layer at each step, set here before the model is built) and
``use_pallas_resblock`` on every ``BasicBlock`` (K10 takes the eligible
ResNet blocks in eval mode), as ``build_model(..., use_pallas_resblock=True)``
sets it.

Kernel launches a batch (a frozen copy of ``recognize.expected_launches(cfg,
use_pallas_resblock=True)``): one frame stack (K2), one K1 attention per
encoder layer, one K10 per ResNet block of stride 1 and equal widths, one
K11 per decoder layer and step; every other kernel none.
"""
from __future__ import annotations

import dataclasses

from port_bench.core import spec

recognize = spec._module(spec.BENCH_DIR / "entries" / "recognize.py", "port_bench_entry_")


def configure(cfg, mix, seed):
    return dataclasses.replace(cfg, use_fused_decoder_layer=True)


def fused_resblock_count(fcfg) -> int:
    """ResNet blocks K10 takes: stride 1 and equal input and output widths."""
    n, c_in = 0, fcfg.conv3d_channels
    for stage, (ch, blocks) in enumerate(zip(fcfg.resnet_channels, fcfg.resnet_blocks)):
        for b in range(blocks):
            n += int(not (stage > 0 and b == 0) and c_in == ch)
            c_in = ch
    return n


def expected_launches(cfg) -> dict:
    dims, d = cfg.dims, cfg.decoder
    return {"small_mha_flat": dims.n_enc_layers, "stack_frames": 1,
            "fused_resblock": fused_resblock_count(cfg.frontend),
            "fused_decoder_layer": d.maxlen * dims.n_dec_layers}


class Part(recognize.Part):
    def __init__(self, torch_mod, model, cfg, conf, mix, seed, dev):
        from sbl_for_multilingual_lip_reading_tpu_torch.models.frontend import BasicBlock
        for m in model.modules():
            if isinstance(m, BasicBlock):
                m.use_pallas_resblock = True
        super().__init__(torch_mod, model, cfg, conf, mix, seed, dev)

    def expected_launches(self):
        return expected_launches(self.cfg)

    def attention_calls(self) -> list:
        """K1's work a batch on path A: every encoder layer's
        self-attention over the clip's frames; K11 takes the decoder's
        attention, so no decoder call is K1's."""
        B, T = self.mix["batch"], self.cfg.data.frames
        return [(B, T, B, T)] * self.cfg.dims.n_enc_layers
