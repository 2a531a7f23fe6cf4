"""What decides ``correct`` for the joint CTC/attention beam
(``entries/ctc_beam.py``): the judged utterances of a sample of batches,
drawn from the seed once the window has closed, against the plain float32
reference ``reference/auto_avsr_vsr.py`` on the same weights and the same
uint8 frames, each utterance alone at its own length.

    ctc_logit_err    the widest distance of the program's CTC
                     log-probabilities from the reference's
    step_logit_err   at every step, the widest distance of the decoder
                     logits the program gave each live hypothesis from the
                     reference decoder's full forward over the same prefix
    ctc_prefix_err   the widest distance of the program's CTC prefix scores
                     of each live hypothesis's candidates from the
                     reference scorer's on the reference's log-probabilities
                     (where the reference finds the prefix possible): the
                     drift of the whole bf16 path summed over the frames
    ctc_prefix_self  the same scores against the reference scorer's on the
                     program's own served log-probabilities: the scorer
                     alone, with the log-probabilities' drift taken out
    frontier_self    the widest break, under the program's own numbers, of
                     the rules of a step: each live hypothesis's candidates
                     are its decoder's pre-beam best labels (and eos), and
                     the step keeps the K best of (1 - w) log p_dec +
                     w (psi(g.c) - psi(g)) added to the hypotheses' scores,
                     a finished hypothesis continuing with eos alone at no
                     cost (the K-th kept total against the best one left)
    dup_hyps         hypotheses that repeat an earlier one of their utterance
    order_off        utterances whose scores are not best first
    score_self       read beside them: the widest distance of a kept
                     score from its candidate's total

The control is the reference in float8 (``prec="fp8"``) in the program's
place on the same frames, prefixes and candidates: its CTC
log-probabilities, its decoder's logits over the program's prefixes, the
reference scorer on its log-probabilities, the frontier rule under its
numbers for the hypotheses the program kept; for ``ctc_prefix_self`` the
reference scorer on the program's served log-probabilities rounded through
float8 (``q8``: the scorer has no product, so its inputs are what the
precision below reaches); it has no search of its own, so ``dup_hyps``
and ``order_off`` are the served answer's.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from ..reference import auto_avsr_vsr as R

IMPOSSIBLE = -1e5     # a prefix score below it: the prefix cannot be emitted
# what the search's ``watch`` gives at a step that the judge reads
STEP_KEYS = ("tokens", "scores", "finished", "logits", "ids", "psi", "psi_prev",
             "parent", "slot", "new_scores")


def row_of(rec: dict, r: int, K: int) -> list:
    """Utterance ``r``'s numbers of one watched step, in STEP_KEYS'
    order (its K hypotheses' rows of the logits)."""
    return [rec["logits"][r * K:(r + 1) * K] if k == "logits" else rec[k][r]
            for k in STEP_KEYS]


def utterance(clip, tokens, scores, ctc, rows: list) -> dict:
    """What ``judge`` takes of one utterance: its frames at its own
    length, its served tokens and scores, its CTC log-probabilities at its
    own length and ``row_of`` of every step."""
    steps = {k: torch.stack([row[i] for row in rows]) for i, k in enumerate(STEP_KEYS)}
    return {"clip": clip, "tokens": tokens, "scores": scores, "ctc": ctc, "steps": steps}


def _cfg(model_cfg: dict) -> dict:
    return dict(model_cfg, blank=model_cfg["blank_id"], eos=model_cfg["vocab_size"] - 1,
                pre_beam=int(model_cfg["pre_beam_ratio"] * model_cfg["beam_size"]))


def frontier_gap(steps: Dict[str, torch.Tensor], logp: torch.Tensor, psi: torch.Tensor,
                 cfg: dict) -> float:
    """The widest break of a step's rules (see the module's doc) over the
    steps, with the decoder's log-probabilities ``logp`` (S, K, V) and the
    prefix scores ``psi`` (S, K, C) given."""
    w, eos, P = cfg["ctc_weight"], cfg["eos"], cfg["pre_beam"]
    ids, fin = steps["ids"], steps["finished"]
    S, K, C = ids.shape
    live = ~fin
    # the pre-beam: the decoder's P best labels of each live hypothesis
    pre = ids[..., :P]
    chosen = torch.zeros_like(logp, dtype=torch.bool).scatter_(2, pre, True)
    low = logp.gather(2, pre).amin(-1)
    high = logp.masked_fill(chosen, float("-inf")).amax(-1)
    gap = (high - low).clamp(min=0)[live]
    worst = float(gap.max()) if gap.numel() else 0.0
    # the totals and the K best of them
    dec = logp.gather(2, ids)
    tot = steps["scores"][..., None] + (1 - w) * dec + w * (psi - steps["psi_prev"][..., None])
    dup = torch.zeros_like(ids, dtype=torch.bool)
    dup[..., :-1] = pre == eos
    tot = tot.masked_fill(dup | (psi < IMPOSSIBLE), float("-inf"))
    frozen = torch.full((C,), float("-inf"), device=tot.device)
    frozen[-1] = 0.0
    tot = torch.where(fin[..., None], steps["scores"][..., None] + frozen, tot)
    flat = tot.reshape(S, K * C)
    kept_at = steps["parent"] * C + steps["slot"]
    kept = flat.gather(1, kept_at)
    left = flat.scatter(1, kept_at, float("-inf")).amax(1)
    # a kept candidate the rules exclude reads as the distance to the best
    # one left; the rules hold where none left beats the worst kept
    worst_kept = torch.where(torch.isfinite(kept), kept,
                             torch.full_like(kept, -1e30)).amin(1)
    brk = (left - worst_kept).clamp(min=0)
    brk = torch.where(torch.isfinite(left), brk, torch.zeros_like(brk))
    return max(worst, float(brk.max().clamp(max=1e9)))


def judge(model_cfg: dict, weights: Dict[str, torch.Tensor], utterances: List[dict],
          device, control: bool = False) -> Dict[str, float]:
    cfg = _cfg(model_cfg)
    R.no_tf32()
    W = R.Weights({k: v.to(device) for k, v in weights.items()})
    blank, eos, w = cfg["blank"], cfg["eos"], cfg["ctc_weight"]
    out: Dict[str, float] = {}

    def keep(name, value):
        out[name] = max(out.get(name, 0.0), float(value))

    with torch.no_grad():
        for u in utterances:
            steps = {k: v.to(device) for k, v in u["steps"].items()}
            clip = u["clip"].to(device)
            tokens, scores = u["tokens"].to(device), u["scores"].to(device)
            S, K, _ = steps["ids"].shape
            live = ~steps["finished"]
            logits = steps["logits"].to(torch.float32)
            logp = torch.log_softmax(logits, -1)
            # the frontier under the program's numbers
            keep("frontier_self", frontier_gap(steps, logp, steps["psi"], cfg))
            tot = (steps["scores"][..., None] + (1 - w) * logp.gather(2, steps["ids"])
                   + w * (steps["psi"] - steps["psi_prev"][..., None]))
            frozen = steps["finished"].gather(1, steps["parent"])
            kept = tot.reshape(S, -1).gather(1, steps["parent"] * tot.shape[-1] + steps["slot"])
            kept = torch.where(frozen, steps["scores"].gather(1, steps["parent"]), kept)
            keep("score_self", (kept - steps["new_scores"]).abs().max())
            same = (tokens[:, None, :] == tokens[None, :, :]).all(-1)
            keep("dup_hyps", out.get("dup_hyps", 0.0)
                 + float((same & torch.ones_like(same).tril(-1)).any(-1).sum()))
            keep("order_off", out.get("order_off", 0.0)
                 + float((scores[1:] > scores[:-1]).any()))
            # the reference, and the control in the program's place
            sides = [("", "f32")] + ([("control_", "fp8")] if control else [])
            enc = R.encode(clip, W, model_cfg)
            x = R.ctc_log_probs(enc, W)
            served_x = u["ctc"].to(device)

            def scores_on(lp):
                return torch.stack([R.prefix_scores(lp, steps["tokens"][s, :, 1:s + 1],
                                                    steps["ids"][s], blank, eos)
                                    for s in range(S)])

            ref_dec = torch.stack([
                R.decoder_logits(steps["tokens"][s, :, :s + 1], enc, W, model_cfg)[:, s]
                for s in range(S)])
            ref_psi, own_psi = scores_on(x), scores_on(served_x)

            def prefix_gap(got, want):
                # where one scorer finds a prefix possible and the other
                # not, the reading is beyond any limit
                mine = live[..., None] & (got > IMPOSSIBLE)
                theirs = live[..., None] & (want > IMPOSSIBLE)
                both = mine & theirs
                err = float((got - want).abs()[both].max()) if both.any() else 0.0
                return err + (1e9 if bool((mine != theirs).any()) else 0.0)

            for tag, prec in sides:
                if prec == "f32":
                    got_x, got_dec, got_psi = served_x, logits, steps["psi"]
                    keep("ctc_prefix_self", prefix_gap(got_psi, own_psi))
                else:
                    enc_c = R.encode(clip, W, model_cfg, prec)
                    got_x = R.ctc_log_probs(enc_c, W, prec)
                    got_dec = torch.stack([
                        R.decoder_logits(steps["tokens"][s, :, :s + 1], enc_c, W, model_cfg,
                                         prec)[:, s] for s in range(S)])
                    got_psi = scores_on(got_x)
                    keep(tag + "ctc_prefix_self",
                         prefix_gap(scores_on(R.q8(served_x, prec)), own_psi))
                    keep(tag + "frontier_self", frontier_gap(
                        steps, torch.log_softmax(got_dec, -1), got_psi, cfg))
                    keep(tag + "dup_hyps", out["dup_hyps"])
                    keep(tag + "order_off", out["order_off"])
                keep(tag + "ctc_logit_err", (got_x - x).abs().max())
                keep(tag + "step_logit_err", (got_dec - ref_dec).abs()[live].max())
                keep(tag + "ctc_prefix_err", prefix_gap(got_psi, ref_psi))
    return out
