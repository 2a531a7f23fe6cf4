"""Device ms a batch of the decode (``models/decoder_sbl.py``,
``models/decoder_uni.py``, ``decode/beam.py``): CUDA events from
``model.encoder``'s forward post-hook to the entry's return, the mean over
the traced slice's batches."""


def read(run):
    ms = run.spans.get("decode")
    return sum(ms) / len(ms) if ms else None
