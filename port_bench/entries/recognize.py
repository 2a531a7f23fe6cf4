"""Entry ``recognize``: ``recognize.recognize_batch(model, clips, crop)``,
the program's greedy decode, as ``cli test`` and a caller of the model run
it a batch at a time.  The SBL model serves both directions' ids and
per-step logits; the unidirectional one (KV-cached) serves ids only, and
its per-step logits are kept as ``UniDecoder._project`` makes them at
each cached step, to be compared with the reference's.

Kernel launches a batch (a frozen copy of ``recognize.expected_launches``
with the eval-side switches off): one frame stack (K2), one K1 attention
per encoder layer, and per decoder layer and decode step two (the SBL
decoder's self and cross attention, both directions in one launch) or one
(the unidirectional decoder's cross attention; its cached self attention
is plain torch).  Every other kernel: none.
"""
from __future__ import annotations

import torch

from port_bench.core import check
from port_bench.core.traffic import ClosedLoop, EvalPart


def expected_launches(cfg) -> dict:
    dims, d = cfg.dims, cfg.decoder
    per_layer = 2 if d.bidirectional else 1
    return {"small_mha_flat": dims.n_enc_layers + per_layer * d.maxlen * dims.n_dec_layers,
            "stack_frames": 1}


class Loop(ClosedLoop):
    held = ("recognize_batch",)

    def __init__(self, model, cfg, mix, seed, device):
        super().__init__(model, cfg, mix, seed, device)
        from sbl_for_multilingual_lip_reading_tpu_torch.recognize import \
            recognize_batch
        self.recognize_batch = recognize_batch
        self.bidirectional = cfg.decoder.bidirectional
        self.steps = None
        if not self.bidirectional:
            self._watch_steps(model.decoder)

    def _watch_steps(self, dec) -> None:
        """Keep the judged row's (or, with ``row`` None, every row's)
        logits as ``UniDecoder._project`` makes them at each cached step."""
        project = dec._project

        def watched(h):
            out = project(h)
            if self.steps is not None:
                self.steps.append(out[:, 0] if self.row is None else out[self.row, 0])
            return out
        dec._project = watched

    def entry(self, clips: torch.Tensor):
        crop = self.cfg.data.crop_size
        if not self.bidirectional:
            self.steps = []
            ids = self.recognize_batch(self.model, clips, crop)
            steps, self.steps = torch.stack(self.steps, dim=-2), None
            return (ids,), (steps,)
        out = self.recognize_batch(self.model, clips, crop)
        logits = (out.logits_l2r, out.logits_r2l)
        if self.row is not None:
            logits = tuple(lg[self.row] for lg in logits)
        return (out.ys_l2r, out.ys_r2l), logits


class Part(EvalPart):
    def make_loop(self):
        return Loop(self.model, self.cfg, self.mix, self.seed, self.dev)

    def expected_launches(self):
        return expected_launches(self.cfg)

    def flops_per_clip(self, flops) -> float:
        return flops.inference_flops_per_clip(self.cfg)

    def attention_calls(self) -> list:
        """K1's work a batch, (query rows, query length, memory rows,
        memory length) a call: every encoder layer's self-attention over
        the clip's frames; for the SBL decoder at each step s, both
        directions' self-attention over the live prefix of s + 1 positions
        (the program pads it to its segment's width) and cross-attention
        over the frames, each direction with a memory of its own (its own
        K/V projection); for the unidirectional decoder the cross-attention
        of the one new position."""
        cfg, B = self.cfg, self.mix["batch"]
        T, L, n_dec = cfg.data.frames, cfg.decoder.maxlen, cfg.dims.n_dec_layers
        out = [(B, T, B, T)] * cfg.dims.n_enc_layers
        if cfg.decoder.bidirectional:
            for s in range(L):
                out += [(2 * B, s + 1, 2 * B, s + 1), (2 * B, s + 1, 2 * B, T)] * n_dec
        else:
            out += [(B, 1, B, T)] * (L * n_dec)
        return out

    def judge(self, state, control=False):
        s = self.sample
        return check.judge_greedy(self.cfg.decoder.bidirectional, self.conf["model"], state,
                                  s["clips"], s["served"], s["logits"], self.dev, control)
