"""Milliseconds of ``TorchBackend.locate_many`` a thousand reads: the
harness's span around each call, on the host's clock (the locate
thread's device launches, waits and host routes)."""


def read(run):
    return 1000.0 * run.span_s("locate") / run.kreads
