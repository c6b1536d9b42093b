from .fastx import read_fastx, FastxRecord, open_maybe_gzip
