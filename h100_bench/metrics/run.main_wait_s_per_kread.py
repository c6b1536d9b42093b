"""Seconds the pipeline's calling thread waits on the align thread a
thousand reads: its ``wait_prep`` spans (each group's prep future);
None without them."""


def read(run):
    if "wait_prep" not in run.stages:
        return None
    return run.stages["wait_prep"] / run.kreads
