"""Seconds the pipeline's calling thread is busy a thousand reads: its
``read_group`` spans (the FASTQ parse of each group) and its
``finalize`` spans (votes, POA collection, writes, checkpoint), from the
program's stages in ``c3poa_stats.json``; None without them."""


def read(run):
    if "finalize" not in run.stages:
        return None
    return (run.stages.get("read_group", 0.0)
            + run.stages["finalize"]) / run.kreads
