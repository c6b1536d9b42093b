"""Seconds the pipeline's align thread waits on the locate thread a
thousand reads: its ``wait_host`` spans (each group's host prep
future); None without them."""


def read(run):
    if "wait_host" not in run.stages:
        return None
    return run.stages["wait_host"] / run.kreads
