"""Seconds of the postprocess run's ``post_demux`` stage (hit
extraction, the trim and orientation rules, the index match and the
record writes, ``pipeline/postprocess.py``) a thousand reads, summed over
the window's calls from ``.c3poa_post_stats.json``; nothing where the
program writes no such stage."""


def read(run):
    if "post_demux" not in run.stages:
        return None
    return run.stages["post_demux"] / run.kreads
