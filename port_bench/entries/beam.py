"""Entry ``beam``: the LRW-1000 evaluation protocol as
``Trainer.validate_seq2seq`` calls it,
``decode.beam.make_uni_beam_decoder(model, beam, bigram_logp)`` on
``data.ingest.device_ingest(clips, crop, dtype)``: KV-cached, a (V, V)
bigram log table built by the benchmark from seeded label sequences
(``reference/bigram.py``).  Tokens (B, K, maxlen+1) and scores (B, K) go
to the host, and the judged clip's frontier at each step.

Mix parameters besides the common ones: ``beam`` (K), ``bigram`` (the
table's parameters).

Kernel launches a batch: one frame stack (K2), one K1 attention per
encoder layer and one per decoder layer and step (the cross attention of
all B x K hypotheses).
"""
from __future__ import annotations

import torch

from port_bench.core import check
from port_bench.core.traffic import ClosedLoop, EvalPart
from port_bench.reference.bigram import seeded_bigram_logp


class Loop(ClosedLoop):
    """Serves the beam's tokens and scores; for the judged clip it keeps,
    as they are made, each step's frontier as the decoder saw it: the last
    token of each of the K hypotheses and the logits the decoder gave them
    (``UniDecoder.decode_step_cached``, watched on the instance)."""
    held = ("beam",)

    def __init__(self, model, cfg, mix, seed, device):
        super().__init__(model, cfg, mix, seed, device)
        from sbl_for_multilingual_lip_reading_tpu_torch.decode.beam import \
            make_uni_beam_decoder
        self.bigram_logp = seeded_bigram_logp(self.seed, cfg.decoder.vocab_size,
                                              mix["bigram"])
        self.beam = make_uni_beam_decoder(
            model, mix["beam"], torch.from_numpy(self.bigram_logp).to(self.device))
        self.steps = None
        self._watch_steps(model.decoder, mix["beam"])

    def _watch_steps(self, dec, K: int) -> None:
        step_fn = dec.decode_step_cached

        def watched(tok, cache, enc_kv, step):
            logits, cache = step_fn(tok, cache, enc_kv, step)
            if self.steps is not None:
                rows = slice(self.row * K, (self.row + 1) * K)
                self.steps.append((tok[rows], logits[rows]))
            return logits, cache
        dec.decode_step_cached = watched

    def entry(self, clips: torch.Tensor):
        from sbl_for_multilingual_lip_reading_tpu_torch.data.ingest import device_ingest
        self.model.eval()
        video = device_ingest(clips, self.cfg.data.crop_size, self.model.frontend.dtype)
        self.steps = []
        served = self.beam(video)
        toks = torch.stack([t for t, _ in self.steps])
        logits = torch.stack([lg for _, lg in self.steps])
        self.steps = None
        return served, (toks, logits)


class Part(EvalPart):
    def make_loop(self):
        return Loop(self.model, self.cfg, self.mix, self.seed, self.dev)

    def expected_launches(self):
        dims = self.cfg.dims
        return {"small_mha_flat": dims.n_enc_layers + self.cfg.decoder.maxlen * dims.n_dec_layers,
                "stack_frames": 1}

    def flops_per_clip(self, flops) -> float:
        return flops.beam_flops_per_clip(self.cfg, self.mix["beam"])

    def attention_calls(self) -> list:
        """K1's work a batch, (query rows, query length, memory rows,
        memory length) a call: every encoder layer's self-attention over
        the clip's frames, and at each step and decoder layer the
        cross-attention of the B x K hypotheses' one new position over
        their clip's frames: the K hypotheses of a clip share its memory,
        so it is read once a clip (the program copies it to every
        hypothesis; the algorithm does not need that)."""
        cfg, B, K = self.cfg, self.mix["batch"], self.mix["beam"]
        T, L, n_dec = cfg.data.frames, cfg.decoder.maxlen, cfg.dims.n_dec_layers
        return [(B, T, B, T)] * cfg.dims.n_enc_layers + [(B * K, 1, B, T)] * (L * n_dec)

    def judge(self, state, control=False):
        s = self.sample
        return check.judge_beam(self.conf["model"], state, s["clips"], s["served"],
                                s["logits"], self.mix["beam"], self.loop.bigram_logp,
                                self.dev, control)
