"""Host ms a step spent in ``next()`` of the epoch's batch iterator (``PatchBatches.epoch``)."""


def read(r):
    waits = r.spans.get("batch_wait")
    return 1e3 * sum(waits) / len(waits) if waits else None
