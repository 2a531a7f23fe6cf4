"""What decides ``correct`` for the evaluation entries: the program's
answers, a sample of them drawn from the seed once the window has closed,
judged by the plain reference (``reference/model.py``) on the same weights
and the same uint8 clips.  An entry's file picks the judge of its answers.

Greedy decodes (``judge_greedy``): the reference runs over each sampled
clip with the tokens the program served before each step; ``logit_err``
is the widest distance between the logits the program served with its
tokens and the reference's at the same step, and ``argmax_off`` counts
the served tokens that are not the first maximum of the logits served
with them.

Beam search (``judge_beam``): the entry serves tokens and scores, and
for the judged clip the frontier at each step as the decoder saw it
(each hypothesis's last token and logits).  The reference runs the
decoder over every returned hypothesis, in float32: how far the logits the
decoder gave each returned prefix lie from the reference's; whether each
served score is the sum of its steps' terms under the program's own
logits, and the hypotheses keep the rule that each step keeps the K best
continuations of the clip's whole frontier under them
(``reference.model.frontier_gaps``); hypotheses that repeat an earlier
one of their clip, clips whose scores are not best first (``fold_beam``).
Under the reference's logits the rule is broken by rounding at near ties,
and a reference search of its own is no yardstick: a bfloat16 search and
a float32 one part at near ties for the K-th place and end on different
hypotheses.

The control is the same reference in float8 (``prec="fp8"``) put in the
program's place: for a greedy decode its logits at the served tokens, for
the beam its own search.  With ``control`` its readings are added under
``control_<name>``.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch

from ..reference import model as R

BLOCK = 16


def _blocks(n: int):
    for a in range(0, n, BLOCK):
        yield slice(a, min(n, a + BLOCK))


def _weights(weights: Dict[str, torch.Tensor], device) -> R.Weights:
    R.no_tf32()
    return R.Weights({k: v.to(device) for k, v in weights.items()})


def judge_greedy(bidirectional: bool, model_cfg: dict, weights: Dict[str, torch.Tensor],
                 clips_u8: torch.Tensor, answer: Sequence[torch.Tensor],
                 logits: Sequence[torch.Tensor], device,
                 control: bool = False) -> Dict[str, float]:
    """The readings of one sample of a greedy decode.  ``bidirectional``:
    answer (ys_l2r, ys_r2l), each (n, maxlen+1), logits (l2r, r2l), each
    (n, maxlen, V); else answer (ids,), logits (steps,); clips_u8 (n, T, H,
    W)."""
    W = _weights(weights, device)
    worst: Dict[str, float] = {}
    counts = {"argmax_off": 0, "control_argmax_off": 0}

    def keep(name, value):
        worst[name] = max(worst.get(name, 0.0), float(value))

    with torch.no_grad():
        for sl in _blocks(clips_u8.shape[0]):
            clips = clips_u8[sl].to(device)
            if bidirectional:
                ys = torch.stack([answer[0][sl], answer[1][sl]]).to(device)
                prog = torch.stack([logits[0][sl], logits[1][sl]]).to(device)

                def ref_of(e, prec="f32"):
                    return R.sbl_teacher_forced(ys, e, W, model_cfg, prec)
            else:
                ys = answer[0][sl].to(device)
                prog = logits[0][sl].to(device)

                def ref_of(e, prec="f32"):
                    return R.uni_logits(ys[..., :-1], e, W, model_cfg, prec)
            served = ys[..., 1:]
            ref = ref_of(R.encode(clips, W, model_cfg))
            outs = [("", prog.to(torch.float32))]
            if control:
                enc_c = R.encode(clips, W, model_cfg, "fp8")
                outs.append(("control_", ref_of(enc_c, "fp8")))
            for tag, lg in outs:
                keep(tag + "logit_err", (lg - ref).abs().max())
                counts[tag + "argmax_off"] += int((lg.argmax(-1) != served).sum())
    worst["argmax_off"] = float(counts["argmax_off"])
    if control:
        worst["control_argmax_off"] = float(counts["control_argmax_off"])
    return worst


def match_steps(tokens: torch.Tensor, step_toks: torch.Tensor, step_logits: torch.Tensor,
                ref: torch.Tensor):
    """Which of the frontier's slots held each returned hypothesis's
    prefix at each step.  tokens (n, K, L) as served; step_toks (n, L-1,
    K) and step_logits (n, L-1, K, V) the frontier's last tokens and
    logits as the decoder made them; ref (n, K, L-1, V) the reference's
    logits at each position of the served tokens.  A prefix was in a slot
    with its last token, the one whose logits lie nearest the reference's.
    Returns (gap (n, K, L-1): the widest distance of those logits from the
    reference's, inf where no slot had the prefix's last token; the
    program's logits of each prefix (n, K, L-1, V))."""
    prog = step_logits.to(torch.float32)
    dist = (prog[:, None] - ref[:, :, :, None]).abs().amax(-1)        # (n, K, L-1, K)
    fits = step_toks[:, None] == tokens[:, :, :-1, None]
    dist = dist.masked_fill(~fits, float("inf"))
    gap, slot = dist.min(-1)
    V = prog.shape[-1]
    idx = slot[..., None, None].expand(*slot.shape, 1, V)
    own = torch.take_along_dim(prog[:, None].expand(-1, tokens.shape[1], -1, -1, -1),
                               idx, dim=3)[..., 0, :]
    return gap, own


def beam_readings(tokens: torch.Tensor, scores: torch.Tensor, step_toks: torch.Tensor,
                  step_logits: torch.Tensor, ref: torch.Tensor,
                  bigram: torch.Tensor) -> Dict[str, float]:
    """The numbers of one block of beam answers (``match_steps`` for the
    shapes), to be folded over the blocks (``fold_beam``)."""
    n, K, L = tokens.shape
    flat = tokens.reshape(n * K, L)
    terms = R.beam_step_terms(flat, ref.reshape(n * K, L - 1, -1), bigram)
    rescored = terms.sum(1).reshape(n, K)
    scores = scores.to(torch.float32)
    live = (terms != 0).sum(1).clamp(min=1).reshape(n, K)
    err = (rescored - scores).abs()
    gap, own = match_steps(tokens, step_toks, step_logits, ref)
    open_ = tokens[:, :, :-1] != R.EOS                                # prefixes still live
    own_terms = R.beam_step_terms(flat, own.reshape(n * K, L - 1, -1), bigram)
    same = (tokens[:, :, None, :] == tokens[:, None, :, :]).all(-1)
    earlier = torch.ones(K, K, dtype=torch.bool, device=tokens.device).tril(-1)
    return {"rel": float((err / rescored.abs()).max()),
            "abs_step": float((err / live).max()),
            "step_logit": float(gap[open_].max().clamp(max=1e9)),
            "self": float((own_terms.sum(1).reshape(n, K) - scores).abs().max()),
            "frontier_self": float(R.frontier_gaps(tokens, own, bigram).max()),
            "gap": float(R.frontier_gaps(tokens, ref, bigram).max()),
            "dup": int((same & earlier).any(-1).sum()),
            "order": int((scores[:, 1:] > scores[:, :-1]).any(-1).sum())}


def fold_beam(parts) -> Dict[str, float]:
    """``step_logit_err``: the widest distance of the logits the decoder
    gave a returned prefix from the reference's; ``score_self``: the
    widest distance of a served score from the sum of its steps' terms
    under the program's own logits; ``frontier_self``: the widest break of
    the frontier's rule (``reference.model.frontier_gaps``) under the
    program's own logits; ``dup_hyps``, ``order_off``.  Read beside them:
    ``score_rel``, ``score_step`` (the served score against the
    reference's score of its tokens, relative and over the live steps)
    and ``frontier_gap`` (the rule under the reference's logits, which
    rounding breaks at near ties)."""
    return {"step_logit_err": max(p["step_logit"] for p in parts),
            "score_self": max(p["self"] for p in parts),
            "frontier_self": max(p["frontier_self"] for p in parts),
            "score_rel": max(p["rel"] for p in parts),
            "score_step": max(p["abs_step"] for p in parts),
            "frontier_gap": max(p["gap"] for p in parts),
            "dup_hyps": float(sum(p["dup"] for p in parts)),
            "order_off": float(sum(p["order"] for p in parts))}


def judge_beam(model_cfg: dict, weights: Dict[str, torch.Tensor], clips_u8: torch.Tensor,
               answer: Sequence[torch.Tensor], steps: Sequence[torch.Tensor], beam: int,
               bigram_logp, device, control: bool = False) -> Dict[str, float]:
    """The readings of one sample of the beam entry: answer (tokens (n, K,
    maxlen+1), scores (n, K)), steps (the frontier's last tokens (n,
    maxlen, K) and logits (n, maxlen, K, V)); clips_u8 (n, T, H, W).  The
    control is the float8 reference's own search on the same clips."""
    W = _weights(weights, device)
    big = torch.as_tensor(bigram_logp, device=device)
    prog, ctl = [], []

    def read(tok, sc, st_tok, st_lg, enc):
        n, K, L = tok.shape
        flat = tok.reshape(n * K, L)
        ref = R.uni_logits(flat[:, :-1], enc.repeat_interleave(K, 0), W, model_cfg)
        return beam_readings(tok, sc, st_tok, st_lg, ref.reshape(n, K, L - 1, -1), big)

    with torch.no_grad():
        for sl in _blocks(clips_u8.shape[0]):
            clips = clips_u8[sl].to(device)
            enc = R.encode(clips, W, model_cfg)
            prog.append(read(*(x[sl].to(device) for x in (*answer, *steps)), enc))
            if control:
                got = R.beam_search(R.encode(clips, W, model_cfg, "fp8"), W, model_cfg,
                                    beam, big, "fp8", frontier=True)
                ctl.append(read(*got, enc))
    out = fold_beam(prog)
    if control:
        out.update({"control_" + k: v for k, v in fold_beam(ctl).items()})
    return out
