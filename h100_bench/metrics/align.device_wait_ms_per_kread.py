"""Milliseconds the align thread waits on the device a thousand reads:
the ``align_wait`` spans of ``TorchBackend.align_many`` (each launch's
gather to the host); None without them."""


def read(run):
    if "align_wait" not in run.stages:
        return None
    return 1000.0 * run.stages["align_wait"] / run.kreads
