"""Milliseconds of ``TorchBackend.align_many`` a thousand reads: the
harness's span around each call, on the host's clock (launches, waits,
record building)."""


def read(run):
    return 1000.0 * run.span_s("align") / run.kreads
