"""Seconds the pipeline's locate thread (``c3_locate``) is busy a
thousand reads: its ``host_prep`` spans (locate, segmentation, pair
building, zero-repeat prep); None without them."""


def read(run):
    if "host_prep" not in run.stages:
        return None
    return run.stages["host_prep"] / run.kreads
