"""Seconds of the process's first ``locate`` stage, its children with
it (kernel loads, dispatch, wait, selection): the warm-up call's cold
first locate, kept by the program's ``prof.first_spans()``; None where
the program keeps no first spans or ran no locate."""


def read(run):
    from c3poa_tpu_torch.utils import prof
    first = getattr(prof, "first_spans", None)
    span = first().get("locate") if first is not None else None
    if span is None:
        return None
    return span[1] - span[0]
