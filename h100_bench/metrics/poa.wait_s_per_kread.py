"""Seconds the main thread waits on the POA pool (stage
``poa_fallback``, ``consensus/engine.py``) a thousand reads; 0 when no
read was routed to it."""


def read(run):
    return run.stages.get("poa_fallback", 0.0) / run.kreads
