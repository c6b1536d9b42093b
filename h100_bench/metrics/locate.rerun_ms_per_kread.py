"""Milliseconds of retried locate work a thousand reads: the
``locate_rerun`` spans of ``TorchBackend.locate_many`` (reads whose
peaks are decided again in float64 on the host); 0 when the program
has the locate spans and reran nothing, None without them."""


def read(run):
    if "locate_wait" not in run.stages:
        return None
    return 1000.0 * run.stages.get("locate_rerun", 0.0) / run.kreads
