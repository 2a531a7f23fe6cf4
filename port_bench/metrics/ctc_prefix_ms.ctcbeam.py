"""Device ms a batch of the CTC prefix scorer (``decode/ctc_prefix.py``):
CUDA events around each call of the search's ``prefix_score``, wrapped on
the instance, summed a batch, the mean over the traced slice's batches."""


def read(run):
    ms = run.spans.get("ctc_prefix")
    return sum(ms) / len(ms) if ms else None
