"""Device ms a batch of the Conformer encoder (``models/conformer.py``):
CUDA events from ``model.frontend``'s forward post-hook to
``model.encoder``'s, the mean over the traced slice's batches (the entry's
``CTCSpans``)."""


def read(run):
    ms = run.spans.get("encoder")
    return sum(ms) / len(ms) if ms else None
