"""Locate cells launched per real one (``locate_cells_padded`` over
``locate_cells_real``): the padding of longest-first batches."""


def read(run):
    real = run.counters.get("locate_cells_real", 0)
    if not real:
        return None
    return run.counters.get("locate_cells_padded", 0) / real
