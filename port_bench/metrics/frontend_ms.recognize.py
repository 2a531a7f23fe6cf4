"""Device ms a batch of the frontend (``models/frontend.py``): CUDA events
at ``model.frontend``'s forward pre- and post-hook, the mean over the
traced slice's batches."""


def read(run):
    ms = run.spans.get("frontend")
    return sum(ms) / len(ms) if ms else None
