"""Entry ``ctc_beam``: sentence-level lip reading with the joint
CTC/attention beam of the Auto-AVSR model, as an offline transcription
(an LRS3-style evaluation, captioning an archive) runs it a batch at a
time: ``data.ingest.device_ingest(clips, crop, dtype, n_frames=lengths,
mean=, std=)`` and ``decode.beam.make_ctc_attention_beam_decoder(model,
cfg)`` on it, tokens (B, K, steps + 1) and scores (B, K) to the host.

Mix parameters besides the common ones: ``min_frames``, ``max_frames``
(each utterance's length, uniform over them, drawn from the seed; a batch
is padded to its longest; batches are not sorted by length).  The search's
width, CTC weight, pre-beam and fixed steps are the configuration's.  Every
batch of the pool has its own padded length; set-up runs the mix's
warm-up batches, and nothing on the path is built per length (K1 and K12
take any length, cuDNN's autotuner stays off).

For the judged utterance of each batch the entry also serves its CTC
log-probabilities (as ``model.ctc_log_probs`` made them, watched on the
instance) and, at each step, the frontier as the search saw it (the
search's ``watch``): the hypotheses' tokens, scores and finished flags,
the decoder's logits, the candidates, their CTC prefix scores, the kept
parents and slots and the new scores.  ``core/judge_ctc.py`` judges them.

Spans of the traced slice (``Spans`` and the wrapped prefix scorer):
``frontend``, ``encoder`` (the frontend's post-hook to the encoder's),
``decode``, and ``ctc_prefix``: CUDA events around each call of the
search's ``prefix_score``, summed a batch.

Kernel launches a batch: one frame stack (K2), one K12 a Conformer block,
one K1 a decoder layer and step (the cross-attention of the K hypotheses
of every utterance over its memory); every other kernel none.
"""
from __future__ import annotations

import numpy as np
import torch

from port_bench.core import judge_ctc
from port_bench.core.traffic import ClosedLoop, EvalPart, Spans, make_clips
from port_bench.reference import flops_auto_avsr, roofline_relpos


class Loop(ClosedLoop):
    held = ("beam", "buffer", "lengths_dev")

    def __init__(self, model, cfg, mix, seed, device):
        super().__init__(model, cfg, dict(mix, pool=0), seed, device)
        from sbl_for_multilingual_lip_reading_tpu_torch.decode.beam import \
            make_ctc_attention_beam_decoder
        self.mix = mix
        B, R, T = mix["batch"], cfg.data.raw_size, cfg.data.frames
        pin = self.device.type == "cuda"
        g = torch.Generator(device=self.device).manual_seed(self.seed)
        rng = np.random.default_rng([self.seed, 5])
        self.lengths = []
        for _ in range(mix["pool"]):
            n = rng.integers(mix["min_frames"], mix["max_frames"] + 1, size=B)
            clips = make_clips(g, B, int(n.max()), R, self.device)
            valid = torch.arange(clips.shape[1], device=self.device)[None, :] < \
                torch.from_numpy(n).to(self.device)[:, None]
            clips = clips * valid[:, :, None, None].to(clips.dtype)
            host = torch.empty(clips.shape, dtype=torch.uint8, pin_memory=pin)
            host.copy_(clips)
            self.pool.append(host)
            self.lengths.append(torch.from_numpy(n).to(torch.int64).pin_memory()
                                if pin else torch.from_numpy(n).to(torch.int64))
        # the clips' device buffer holds the longest batch; each batch a view
        self.buffer = self.clips.reshape(-1)
        self.lengths_dev = torch.empty(B, dtype=torch.int64, device=self.device)
        self.beam = make_ctc_attention_beam_decoder(model, cfg)
        self.beam.watch = self._watch
        self.steps = None
        self.ctc_row = None
        log_probs = model.ctc_log_probs

        def watched(enc):
            out = log_probs(enc)
            if self.steps is not None:
                self.ctc_row = out[self.row]
            return out
        model.ctc_log_probs = watched

    def _watch(self, rec: dict) -> None:
        if self.steps is None:
            return
        self.steps.append(judge_ctc.row_of(rec, self.row, self.beam.K))

    def batch(self, i: int, keep: bool = True) -> float:
        j = i % len(self.pool)
        self.clips = self.buffer[:self.pool[j].numel()].view(self.pool[j].shape)
        self.pool_index = j
        return super().batch(i, keep)

    def entry(self, clips: torch.Tensor):
        from sbl_for_multilingual_lip_reading_tpu_torch.data.ingest import device_ingest
        cfg = self.cfg
        lengths = self.lengths_dev
        lengths.copy_(self.lengths[self.pool_index], non_blocking=True)
        self.model.eval()
        video = device_ingest(clips, cfg.data.crop_size, self.model.frontend.dtype,
                              n_frames=lengths, mean=cfg.data.mean, std=cfg.data.std)
        self.steps = []
        served = self.beam(video, lengths)
        steps = [torch.stack([s[k] for s in self.steps])
                 for k in range(len(judge_ctc.STEP_KEYS))]
        T = cfg.data.frames
        ctc = torch.zeros((T, self.ctc_row.shape[-1]), dtype=torch.float32,
                          device=clips.device)
        ctc[:self.ctc_row.shape[0]] = self.ctc_row
        self.steps = self.ctc_row = None
        return served, (ctc, *steps)

    def sample(self, n: int) -> dict:
        """``n`` answered batches drawn from the seed, each with its judged
        utterance: its frames at its own length, what was served for it,
        and its CTC log-probabilities and steps."""
        rng = np.random.default_rng([self.seed, 1])
        picks = sorted(rng.choice(len(self.answers), size=min(n, len(self.answers)),
                                  replace=False).tolist())
        out = []
        for p in picks:
            a = self.answers[p]
            r, j = a["row"], a["pool"]
            length = int(self.lengths[j][r])
            out.append({"clip": self.pool[j][r, :length], "length": length,
                        "tokens": a["served"][0][r], "scores": a["served"][1][r],
                        "ctc": a["logits"][0][:length],
                        "steps": dict(zip(judge_ctc.STEP_KEYS, a["logits"][1:]))})
        return {"utterances": out, "batches": picks}


class CTCSpans(Spans):
    """The benchmark's spans, with the encoder's: from the frontend's
    forward post-hook to the encoder's."""

    def ms(self):
        out = super().ms()
        out["encoder"] = [r["f1"].elapsed_time(r["e1"]) for r in self.rows
                          if "f1" in r and "e1" in r]
        return out


class Part(EvalPart):
    def make_loop(self):
        return Loop(self.model, self.cfg, self.mix, self.seed, self.dev)

    def expected_launches(self):
        dims = self.cfg.dims
        return {"small_mha_flat": self.cfg.decoder.maxlen * dims.n_dec_layers,
                "fused_mha": dims.n_enc_layers, "stack_frames": 1}

    def spans(self, model) -> dict:
        beam = self.loop.beam
        score = beam.prefix_score
        sums, cur = [], []

        def timed(*args):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = score(*args)
            b.record()
            cur.append((a, b))
            return out

        def served():
            sp.served()
            sums.append(list(cur))
            cur.clear()

        beam.prefix_score = timed
        with CTCSpans(model) as sp:
            self.loop.on_served = served
            self.traced_slice()
            self.loop.on_served = None
        beam.prefix_score = score
        out = sp.ms()
        out["ctc_prefix"] = [sum(a.elapsed_time(b) for a, b in batch) for batch in sums]
        return out

    def traced_slice(self) -> None:
        self.traced = []
        for _ in range(self.mix["trace_batches"]):
            self.traced.append(self.i % len(self.loop.pool))
            self.loop.batch(self.i, keep=False)
            self.i += 1

    def flops_per_clip(self, flops) -> float:
        return flops_auto_avsr.flops_per_utterance(self.cfg, self.mix)

    def attention_work(self):
        """(launches, least seconds) of K12 and K1 over the last traced
        slice's batches, at each utterance's real length
        (``reference/roofline_relpos.py``)."""
        dims = self.cfg.dims
        H, d, K = dims.n_head, dims.d_k, self.cfg.conformer.beam_size
        launches, least = 0, 0.0
        for j in getattr(self, "traced", []):
            lengths = [int(t) for t in self.loop.lengths[j]]
            launches += sum(self.expected_launches()[k] for k in ("fused_mha", "small_mha_flat"))
            least += dims.n_enc_layers * roofline_relpos.relpos_self_attention_s(lengths, H, d)
            least += (self.cfg.decoder.maxlen * dims.n_dec_layers
                      * roofline_relpos.beam_cross_attention_s(lengths, K, H, d))
        return launches, least

    def judge(self, state, control=False):
        return judge_ctc.judge(self.conf["model"], state, self.sample["utterances"],
                               self.dev, control)
