"""Milliseconds of ``TorchBackend.adapter_hits`` a thousand reads: the
harness's span around each call (``entries/postprocess.py:Recorder``),
on the host's clock (packing, upload, the adapter kernel's launches and
the wait for their outputs)."""


def read(run):
    return 1000.0 * run.span_s("adapter") / run.kreads
