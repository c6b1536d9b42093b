"""Multi-process, multi-host and multi-device runs (counterpart of
``c3poa_tpu/parallel``).

Import submodules directly (``parallel.dist``, ``parallel.mesh``), as in
the original: this package re-exports nothing.
"""
