"""Milliseconds the locate thread waits on the device a thousand reads:
the ``locate_wait`` spans of ``TorchBackend.locate_many`` (each batch's
gather to the host); None without them."""


def read(run):
    if "locate_wait" not in run.stages:
        return None
    return 1000.0 * run.stages["locate_wait"] / run.kreads
