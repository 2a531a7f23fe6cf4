"""Search-based decoding: batched beam search and the bigram-LM bias."""
from .beam import (beam_search, beam_search_cached, make_sbl_beam_decoder,
                   make_uni_beam_decoder, sbl_beam_search)
from .bigram import bigram_from_dataset, build_bigram_matrix
