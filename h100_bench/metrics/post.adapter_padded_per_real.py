"""Adapter cells launched per real one (``adapter_cells_padded`` over
``adapter_cells_real``, ``TorchBackend.adapter_hits``): the padding of
its longest-first batches; nothing where the program counts no such
cells."""


def read(run):
    real = run.counters.get("adapter_cells_real", 0)
    if not real:
        return None
    return run.counters.get("adapter_cells_padded", 0) / real
