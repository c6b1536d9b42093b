"""Seconds of the ``consensus`` stage (pair building, the round-1
alignment's host half, votes; ``consensus/``, ``native.py``) a thousand
reads, summed over the window's calls and across threads
(``c3poa_stats.json``)."""


def read(run):
    return run.stages.get("consensus", 0.0) / run.kreads
