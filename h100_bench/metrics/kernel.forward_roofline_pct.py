"""The banded forward kernel's share of its roofline: the least time of
``banded_fwd_kernel`` for the window's real align cells
(``counts/banded_fwd_kernel.json``), over its device time, in percent."""


def read(run):
    return run.roofline_pct(("banded_fwd_kernel",))
