"""Search-based decoding: batched beam search, the bigram-LM bias and the
joint CTC/attention search with its CTC prefix scorer."""
from .beam import (beam_search, beam_search_cached, make_ctc_attention_beam_decoder,
                   make_sbl_beam_decoder, make_uni_beam_decoder, sbl_beam_search)
from .bigram import bigram_from_dataset, build_bigram_matrix
