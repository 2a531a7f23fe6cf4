"""Batched beam search with an optional bigram-LM bias (counterpart of the
JAX package's ``decode/beam.py``).

The whole batch x beam frontier advances together: hypotheses live in
fixed-size (B, K, L) token buffers, expansion is one (B, K*V) top-k per
step, and the per-step ``log_softmax + log(bigram_freq[last_id])`` bias is a
row gather from a (V, V) table.  The JAX ``lax.scan`` bodies are Python
loops here.

Semantics, as in JAX: finished hypotheses (they emitted eos) are frozen --
they compete in the frontier with an unchanged score and extend only with
eos at zero cost.  After maxlen steps every hypothesis is eos-terminated.

Ties: ``jax.lax.top_k`` and ``jnp.argsort`` give equal values in order of
ascending index; ``torch.topk`` promises no order, so ``top_k`` here is the
head of a stable descending sort.  Scores are not touched.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ..models.decoder_uni import make_uni_cache
from ..models.layers import cast_dense_weights
from ..vocab import EOS_ID, SOS_ID

NEG_INF = -1e9


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries along the last axis, descending; among equal
    values the lowest index first (``jax.lax.top_k``'s order)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _eos_only(V: int, eos_id: int, device) -> torch.Tensor:
    row = torch.full((V,), NEG_INF, dtype=torch.float32, device=device)
    row[eos_id] = 0.0
    return row


def _start(B: int, K: int, L: int, sos_id: int, device):
    tokens = torch.full((B, K, L), sos_id, dtype=torch.int64, device=device)
    # only hypothesis 0 is live at first, so the first expansion yields K
    # distinct continuations
    scores = torch.full((B, K), NEG_INF, dtype=torch.float32, device=device)
    scores[:, 0] = 0.0
    finished = torch.zeros((B, K), dtype=torch.bool, device=device)
    return tokens, scores, finished


def _sorted_by_score(scores: torch.Tensor, *tokens: torch.Tensor):
    order = torch.argsort(-scores, dim=1, stable=True)
    out = [torch.take_along_dim(t, order[..., None], dim=1) for t in tokens]
    return (*out, torch.take_along_dim(scores, order, dim=1))


def _advance(tokens: torch.Tensor, scores: torch.Tensor, finished: torch.Tensor,
             logp: torch.Tensor, step: int, last: torch.Tensor,
             bigram_logp: Optional[torch.Tensor], eos_id: int):
    """One frontier step shared by the cached and uncached beams: bigram
    bias, freezing of finished hypotheses (eos-only continuation at zero
    cost), (B, K*V) top-k, parent gather, token write at ``step + 1``.
    Returns (tokens, scores, finished, parent)."""
    B, K, _ = tokens.shape
    V = logp.shape[-1]
    if bigram_logp is not None:
        logp = logp + bigram_logp[last]
    logp = torch.where(finished[..., None],
                       _eos_only(V, eos_id, logp.device)[None, None, :], logp)
    cand = scores[..., None] + logp                      # (B, K, V)
    new_scores, idx = top_k(cand.reshape(B, K * V), K)
    parent = idx // V
    tok = idx % V
    tokens = torch.take_along_dim(tokens, parent[..., None], dim=1)
    tokens[:, :, step + 1] = tok
    finished = torch.take_along_dim(finished, parent, dim=1) | (tok == eos_id)
    return tokens, new_scores, finished, parent


def beam_search(step_fn: Callable[[torch.Tensor, int], torch.Tensor],
                enc_output: torch.Tensor, beam_size: int, maxlen: int,
                vocab_size: int, bigram_logp: Optional[torch.Tensor] = None,
                eos_id: int = EOS_ID, sos_id: int = SOS_ID
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run beam search.

    step_fn(ys, step) -> (N, V) logits for the token at position ``step``
        given token buffers ys (N, L); N = B*K (the closure carries the
        pre-tiled encoder outputs).
    enc_output: (B, T, D), read for the batch size and the device only.
    bigram_logp: optional (V, V) f32 log-bias table, row = last token id.

    Returns (tokens (B, K, L) with the leading sos, scores (B, K)), sorted
    by score descending along K."""
    B = enc_output.shape[0]
    K, V, L = beam_size, vocab_size, maxlen + 1
    tokens, scores, finished = _start(B, K, L, sos_id, enc_output.device)
    for step in range(maxlen):
        logits = step_fn(tokens.reshape(B * K, L), step).reshape(B, K, V)
        logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
        tokens, scores, finished, _ = _advance(
            tokens, scores, finished, logp, step, tokens[:, :, step],
            bigram_logp, eos_id)
    return _sorted_by_score(scores, tokens)


def beam_search_cached(step_fn: Callable, cache0, batch_size: int,
                       beam_size: int, maxlen: int, vocab_size: int,
                       bigram_logp: Optional[torch.Tensor] = None,
                       eos_id: int = EOS_ID, sos_id: int = SOS_ID, device=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """KV-cached beam search: the frontier semantics of ``beam_search``
    (token-identical), but the step function takes only the LAST token and a
    per-hypothesis cache, and the cache rows are re-gathered by parent after
    every top-k, so a step costs one token's decoder work.

    step_fn(tok (N,), cache, step) -> (logits (N, V), new cache); N = B*K.
    cache0: nested tuples of (N, ...) tensors (``make_uni_cache``)."""
    B, K, V, L = batch_size, beam_size, vocab_size, maxlen + 1
    tokens, scores, finished = _start(B, K, L, sos_id, device)
    cache = cache0
    for step in range(maxlen):
        last = tokens[:, :, step]
        logits, cache = step_fn(last.reshape(B * K), cache, step)
        logp = torch.log_softmax(logits.to(torch.float32), dim=-1).reshape(B, K, V)
        tokens, scores, finished, parent = _advance(
            tokens, scores, finished, logp, step, last, bigram_logp, eos_id)
        # the surviving hypotheses' caches are their parents'
        flat_parent = (torch.arange(B, device=parent.device)[:, None] * K
                       + parent).reshape(-1)
        cache = tuple(tuple(c[flat_parent] for c in layer) for layer in cache)
    return _sorted_by_score(scores, tokens)


def sbl_beam_search(step_fn: Callable, batch_size: int, beam_size: int,
                    maxlen: int, vocab_size: int, eos_id: int = EOS_ID,
                    sos_id: int = SOS_ID, device=None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched bidirectional beam search over PAIRED (l2r, r2l) hypotheses.

    The SBL decoder fuses the two directions' hidden states after every
    layer, so a hypothesis is a pair of prefixes.  The frontier is K pairs;
    each step expands every pair jointly over V x V continuations scored by
    the sum of the directions' log-probabilities, then takes one
    (B, K*V*V) top-k.  With beam 1 this is the synchronous greedy argmax per
    direction.  A direction that emitted eos is frozen and extends only with
    eos at zero cost, and the pair keeps competing in the frontier.

    step_fn(ys_l2r, ys_r2l, step) -> ((N, V), (N, V)) logits at position
        ``step``; N = B*K (the closure carries the pre-tiled encoder K/V).

    Returns (tokens_l2r (B, K, L), tokens_r2l (B, K, L), scores (B, K)),
    sorted by joint score descending along K, each with the leading sos."""
    B, K, V, L = batch_size, beam_size, vocab_size, maxlen + 1
    tok_l, scores, fin_l = _start(B, K, L, sos_id, device)
    tok_r, fin_r = tok_l.clone(), fin_l.clone()
    eos_only = _eos_only(V, eos_id, device)[None, None]
    for step in range(maxlen):
        lg_l, lg_r = step_fn(tok_l.reshape(B * K, L), tok_r.reshape(B * K, L),
                             step)
        lp_l = torch.log_softmax(lg_l.to(torch.float32), -1).reshape(B, K, V)
        lp_r = torch.log_softmax(lg_r.to(torch.float32), -1).reshape(B, K, V)
        lp_l = torch.where(fin_l[..., None], eos_only, lp_l)
        lp_r = torch.where(fin_r[..., None], eos_only, lp_r)
        cand = (scores[..., None, None] + lp_l[..., :, None]
                + lp_r[..., None, :])                    # (B, K, V, V)
        scores, idx = top_k(cand.reshape(B, K * V * V), K)
        parent = idx // (V * V)
        rem = idx % (V * V)
        a = rem // V                                     # l2r token
        b = rem % V                                      # r2l token
        tok_l = torch.take_along_dim(tok_l, parent[..., None], dim=1)
        tok_r = torch.take_along_dim(tok_r, parent[..., None], dim=1)
        tok_l[:, :, step + 1] = a
        tok_r[:, :, step + 1] = b
        fin_l = torch.take_along_dim(fin_l, parent, dim=1) | (a == eos_id)
        fin_r = torch.take_along_dim(fin_r, parent, dim=1) | (b == eos_id)
    return _sorted_by_score(scores, tok_l, tok_r)


def make_sbl_beam_decoder(model, beam_size: int = 5) -> Callable:
    """Batched bidirectional beam decode for an ``SBLTransformer``: video ->
    (tokens_l2r (B, K, L), tokens_r2l (B, K, L), scores (B, K)).  The
    cross-attention K/V are projected once for the whole search."""
    dec = model.decoder

    def decode(video: torch.Tensor):
        with torch.inference_mode(), cast_dense_weights(model):
            enc = model.encode(video)
            B = enc.shape[0]
            enc_kv = dec.compute_cross_kv(
                enc.repeat_interleave(beam_size, dim=0))    # (2, B*K, T, D)

            def step_fn(ys_l, ys_r, step):
                return dec.step_logits_cached(ys_l, ys_r, enc_kv, step)

            return sbl_beam_search(step_fn, B, beam_size, dec.maxlen,
                                   dec.vocab_size, device=enc.device)

    return decode


def make_uni_beam_decoder(model, beam_size: int = 5,
                          bigram_logp: Optional[torch.Tensor] = None,
                          kv_cache: bool = True) -> Callable:
    """Batched beam decode for a ``UniTransformer``: video -> (tokens
    (B, K, L), scores (B, K)).  By default the search carries per-layer
    self-attention K/V caches (``beam_search_cached``); ``kv_cache=False``
    keeps the full-prefix re-run of every step, for parity checks."""
    dec = model.decoder

    def decode(video: torch.Tensor):
        with torch.inference_mode(), cast_dense_weights(model):
            enc = model.encode(video)
            B = enc.shape[0]
            K = beam_size
            big = None if bigram_logp is None else torch.as_tensor(
                bigram_logp, dtype=torch.float32, device=enc.device)
            # cross-attention K/V projected once for the whole search
            enc_kv = dec.compute_cross_kv(enc.repeat_interleave(K, dim=0))
            if kv_cache:
                cache0 = make_uni_cache(B * K, dec.maxlen + 1, dec.n_layers,
                                        dec.n_head * dec.d_k,
                                        dec.n_head * dec.d_v, dec.dtype,
                                        enc.device)

                def step_fn_kv(tok, cache, step):
                    return dec.decode_step_cached(tok, cache, enc_kv, step)

                return beam_search_cached(step_fn_kv, cache0, B, K, dec.maxlen,
                                          dec.vocab_size, bigram_logp=big,
                                          device=enc.device)

            def step_fn(ys, step):
                return dec.step_logits_cached(ys, enc_kv, step)

            return beam_search(step_fn, enc, K, dec.maxlen, dec.vocab_size,
                               bigram_logp=big)

    return decode
