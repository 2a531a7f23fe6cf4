"""Batched CTC prefix scoring for the joint CTC/attention beam search, with
the semantics of ESPnet's ``CTCPrefixScoreTH`` (Watanabe et al., "Hybrid
CTC/attention architecture for end-to-end speech recognition", 2017).

A hypothesis is a label prefix g.  Its state is, at every frame t, the
log-probabilities that the first t + 1 frames emit g ending in a non-blank
(r^n_t) or in a blank (r^b_t).  For a candidate label c the prefix g.c gets

    phi_t    = log(r^n_t(g) + r^b_t(g)), or r^b_t(g) alone when c is g's
               last label (a repeat needs a blank in between)
    r^n_t    = logaddexp(r^n_{t-1}(g.c), phi_{t-1}) + x_t(c)
    r^b_t    = logaddexp(r^n_{t-1}(g.c), r^b_{t-1}(g.c)) + x_t(blank)
    psi(g.c) = logsumexp(r^n_{s-1}(g.c), phi_{t-1} + x_t(c) for t >= s)

where x are the CTC log-probabilities and s = max(|g|, 1) the first frame
at which g.c can end (earlier frames stay at ``NEG``).  psi is the
log-probability that the utterance's labels begin with g.c; for eos it is
the whole sequence's, log(r^n + r^b) of g at the utterance's last frame,
and the blank is never a candidate.  Frames past an utterance's length
emit the blank with probability one.  ``NEG`` is ESPnet's logzero.

Each recursion is first order in the log semiring, so it has a closed
form that needs no loop over frames: with A_t the running sum of x(c) from
the first frame on, r^n_t = A_t + logcumsumexp_tau(e_tau), where e holds
r^n at the first frame and phi_{tau-1} - A_{tau-1} after it; r^b likewise
with the running sum of x(blank); and psi(g.c) = logsumexp(e + A).  A
step is some fifteen launches over (frames, N, C) arrays for every
(hypothesis, candidate) at once, in float64, where the sums of hundreds of
log-probabilities cancel; the states are float64 too.
``ctc_prefix.cells`` counts the frames x candidates x hypotheses scanned.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

NEG = -1e10


class PrefixState(NamedTuple):
    """The hypotheses' CTC states: r (frames from t0 on, 2, N) as (r^n,
    r^b), float64; psi (N,) each prefix's own score (0 for the empty
    prefix)."""
    r: torch.Tensor
    psi: torch.Tensor
    t0: int


def frames_first(log_probs: torch.Tensor, lengths: Optional[torch.Tensor],
                 blank: int) -> torch.Tensor:
    """(B, T, V) f32 CTC log-probabilities -> (T, B, V), frames at or past
    each utterance's length giving the blank log 1 and every other label
    ``NEG`` (ESPnet's padding)."""
    x = log_probs.to(torch.float32).transpose(0, 1)
    if lengths is not None:
        T = x.shape[0]
        pad = torch.arange(T, device=x.device)[:, None] >= lengths[None, :]
        fill = torch.full((x.shape[-1],), NEG, dtype=x.dtype, device=x.device)
        fill[blank] = 0.0
        x = torch.where(pad[..., None], fill, x)
    return x.contiguous()


def initial_state(x: torch.Tensor, K: int, blank: int) -> PrefixState:
    """The empty prefix for K hypotheses an utterance: r^n = NEG, r^b the
    running sum of the blank's log-probabilities."""
    rb = torch.cumsum(x[:, :, blank].to(torch.float64), dim=0).repeat_interleave(K, dim=1)
    r = torch.stack([torch.full_like(rb, NEG), rb], dim=1)
    return PrefixState(r, torch.zeros(rb.shape[1], dtype=x.dtype, device=x.device), 0)


def _running_sum(x: torch.Tensor) -> torch.Tensor:
    """A_t = x_1 + ... + x_t along dim 0 (A_0 = 0)."""
    a = x.clone()
    a[0] = 0.0
    return a.cumsum_(0)


def ctc_prefix(x: torch.Tensor, lengths: torch.Tensor, state: PrefixState,
               last: torch.Tensor, cand: torch.Tensor, step: int, blank: int,
               eos: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Score every candidate of every hypothesis at decode step ``step``
    (each prefix holds ``step`` labels).

    x: ``frames_first``'s (T, B, V); lengths (B,) frames of each
    utterance; state: the N = B x K hypotheses' (utterance-major);
    last (N,) each prefix's last label (sos for the empty one); cand
    (N, C) candidate labels.  Returns (psi (N, C) f32: the prefix scores
    of g.c, log r^n + r^b at the last frame for eos, NEG for the blank;
    the states of every g.c (frames from max(step, 1) - 1 on, 2, N, C) as
    (r^n, r^b), which ``select`` reads)."""
    T, B, V = x.shape
    N, C = cand.shape
    K = N // B
    f64 = torch.float64
    t0 = max(step, 1) - 1
    r_prev = state.r[t0 - state.t0:]                                   # (Tn, 2, N)
    Tn = T - t0
    xs = x[t0:]
    xn = torch.gather(xs, 2, cand.view(1, B, K * C).expand(Tn, B, K * C))
    xn = xn.view(Tn, N, C).to(f64)
    bsum = _running_sum(xs[:, :, blank].to(f64).repeat_interleave(K, dim=1))  # (Tn, N)
    r_sum = torch.logaddexp(r_prev[:, 0], r_prev[:, 1])                # (Tn, N)
    # r^n: e_0 = r^n at the first frame, e_tau = phi_{tau-1} - A_{tau-1}
    A = _running_sum(xn)
    e = torch.empty_like(xn)
    e[0] = xn[0] if step == 0 else NEG
    repeat = (cand == last[:, None])[None]                             # (1, N, C)
    torch.where(repeat, r_prev[:-1, 1, :, None], r_sum[:-1, :, None], out=e[1:])
    e[1:] -= A[:-1]
    W = torch.empty((Tn, 2, N, C), dtype=f64, device=x.device)
    torch.logcumsumexp(e, 0, out=W[:, 0])
    W[:, 0] += A
    # r^b: d_0 = NEG, d_tau = r^n_{tau-1} - Bsum_{tau-1}
    d = torch.empty_like(xn)
    d[0] = NEG
    torch.sub(W[:-1, 0], bsum[:-1, :, None], out=d[1:])
    torch.logcumsumexp(d, 0, out=W[:, 1])
    W[:, 1] += bsum[..., None]
    # psi: the first frame's r^n and every later frame's first completion
    psi = torch.logsumexp(e.add_(A), dim=0)
    # eos: the whole prefix g, read at each utterance's last frame
    end = (lengths.repeat_interleave(K) - 1 - t0).clamp(min=0)
    whole = r_sum.gather(0, end[None]).squeeze(0)                     # (N,)
    psi = torch.where(cand == eos, whole[:, None], psi)
    psi = psi.masked_fill(cand == blank, NEG).to(torch.float32)
    ctc_prefix.cells += Tn * N * C
    return psi, W


ctc_prefix.cells = 0


def select(W: torch.Tensor, psi: torch.Tensor, step: int,
           rows: torch.Tensor, slots: torch.Tensor) -> PrefixState:
    """The states of the hypotheses kept after a step: hypothesis i
    extends row ``rows[i]`` of the last ``ctc_prefix`` call with its
    candidate ``slots[i]``."""
    Tn, _, N, C = W.shape
    flat = rows * C + slots
    r = W.view(Tn, 2, N * C)[:, :, flat]                              # (Tn, 2, N)
    return PrefixState(r, psi.reshape(-1)[flat], max(step, 1) - 1)
