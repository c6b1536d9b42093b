"""Share of the traced window in which no device activity ran, in
percent (1 - the union of activity intervals over the window)."""


def read(run):
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
