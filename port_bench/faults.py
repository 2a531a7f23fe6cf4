"""Faults of the beam's frontier, planted in the program to read what the
judgement makes of them: by the CPU tests (``tests/test_bench_run.py``)
and on the card at the cell's size (``control.py --fault <name>``).  Each
takes a ``setattr``-like function (``monkeypatch.setattr`` in a test) and
leaves every score its tokens' true score."""
from __future__ import annotations

import torch


def per_beam_top_k(patch=setattr) -> None:
    """The frontier taken per hypothesis after the first step: each keeps
    its own best continuation, instead of the K best of the clip's whole
    frontier."""
    from sbl_for_multilingual_lip_reading_tpu_torch.decode import beam
    advance = beam._advance

    def per_beam(tokens, scores, finished, logp, step, last, bigram_logp, eos_id):
        if step == 0:
            return advance(tokens, scores, finished, logp, step, last, bigram_logp, eos_id)
        B, K, _ = tokens.shape
        V = logp.shape[-1]
        logp = logp + bigram_logp[last]
        logp = torch.where(finished[..., None],
                           beam._eos_only(V, eos_id, logp.device)[None, None, :], logp)
        new_scores, tok = (scores[..., None] + logp).max(-1)
        tokens = tokens.clone()
        tokens[:, :, step + 1] = tok
        parent = torch.arange(K, device=tokens.device).expand(B, K)
        return tokens, new_scores, finished | (tok == eos_id), parent
    patch(beam, "_advance", per_beam)


def duplicated_beam(patch=setattr) -> None:
    """The best hypothesis returned twice, in place of the second."""
    from sbl_for_multilingual_lip_reading_tpu_torch.decode import beam
    sort = beam._sorted_by_score

    def dup(scores, *tokens):
        out = [t.clone() for t in sort(scores, *tokens)]
        for t in out:
            t[:, 1] = t[:, 0]
        return tuple(out)
    patch(beam, "_sorted_by_score", dup)


def worst_first(patch=setattr) -> None:
    """The hypotheses returned worst first."""
    from sbl_for_multilingual_lip_reading_tpu_torch.decode import beam
    sort = beam._sorted_by_score
    patch(beam, "_sorted_by_score",
          lambda scores, *tokens: tuple(t.flip(1) for t in sort(scores, *tokens)))


FAULTS = {f.__name__: f for f in (per_beam_top_k, duplicated_beam, worst_first)}
