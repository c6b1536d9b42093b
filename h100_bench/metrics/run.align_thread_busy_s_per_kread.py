"""Seconds the pipeline's align thread (``c3_align``) is busy a thousand
reads: its ``device_prep`` spans (round-1 ``align_many``, embedding, the
POA submit, the zero-repeat batch); None without them."""


def read(run):
    if "device_prep" not in run.stages:
        return None
    return run.stages["device_prep"] / run.kreads
