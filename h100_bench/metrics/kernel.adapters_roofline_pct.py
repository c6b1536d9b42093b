"""The adapter kernel's share of its roofline: the least time of
``adapter_hits_kernel`` for the window's real cells and read columns
(``counts/adapter_hits_kernel.json``, units from the program's counters
``adapter_cells_real`` and ``adapter_read_columns``) over its device time
(``torch.profiler``), in percent; nothing where the program counts no
such units."""

KERNELS = ("adapter_hits_kernel",)


def read(run):
    if not run.counters.get("adapter_cells_real") or \
            not run.counters.get("adapter_read_columns"):
        return None
    return run.roofline_pct(KERNELS)
