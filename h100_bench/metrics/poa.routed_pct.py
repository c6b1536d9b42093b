"""Share of the window's reads the divergence test routed to the POA
pool (counter ``poa_fallback_reads``), in percent."""


def read(run):
    return 100.0 * run.counters.get("poa_fallback_reads", 0) / run.reads
