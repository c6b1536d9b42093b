"""The locate kernels' share of their roofline: the summed least times
of ``profile_kernel``, ``smooth3_kernel`` and ``pk_kernel`` for the
window's real cells and columns (``counts/``), over their summed device
time (``torch.profiler``), in percent."""

KERNELS = ("profile_kernel", "smooth3_kernel", "pk_kernel")


def read(run):
    return run.roofline_pct(KERNELS)
