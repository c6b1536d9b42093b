"""Cross-layer scalar constants with no jax/numpy imports.

This module must stay import-free: pipeline code running in numpy-only
multiprocessing workers reads these values, and pulling in a kernels
module (whose module scope creates jnp scalars) would initialize the
accelerator backend inside every spawned worker.
"""

# A second adapter hit only counts when its aligned span is
# (near-)disjoint from the best hit's span: shifted self-alignments of a
# self-similar adapter (the bundled 5' adapter scores 31 against itself
# at shift ~13) overlap the best span heavily, while a genuine second
# adapter copy — even an adjacent dimer — occupies its own span.  Spans
# may share at most this many columns.  Shared by kernels/adapters.py
# and pipeline/backend.py so both backends report identical second hits.
ADAPTER_OVERLAP_TOL = 4
