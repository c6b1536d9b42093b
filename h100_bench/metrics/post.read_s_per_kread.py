"""Seconds of the postprocess run's FASTA parse and encode (stages
``post_read`` and ``post_encode``, ``pipeline/postprocess.py``) a
thousand reads, summed over the window's calls from
``.c3poa_post_stats.json``; nothing where the program writes no such
stages."""


def read(run):
    if "post_read" not in run.stages:
        return None
    return (run.stages["post_read"] + run.stages.get("post_encode", 0.0)) \
        / run.kreads
