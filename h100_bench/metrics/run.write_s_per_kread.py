"""Seconds of the pipeline's ``write`` stage (record formatting and the
writes, ``pipeline/run.py``) a thousand reads, summed over the window's
calls from ``c3poa_stats.json``."""


def read(run):
    return run.stages.get("write", 0.0) / run.kreads
