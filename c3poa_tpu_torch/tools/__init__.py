"""The port's tools, the counterparts of ``c3poa_tpu/tools/`` and of the
repo's TPU probes:

- ``make_example`` and ``demux_nextera_tso``: copies of
  ``c3poa_tpu/tools/``'s, held to them by tests;
- ``int16_probe``: packed int16 max / roll / select / add on the card
  (counterpart of ``tools/int16_probe.py``);
- ``floor_probe``: the issue cost of dependent int32 operations on one
  SM (counterpart of ``tools/mosaic_floor_probe.py``);
- ``banded_sass``: SASS instructions a row of the banded forward kernel,
  by pipe (needs nvcc and cuobjdump);
- ``banded_chain``: the banded kernels on a batch and on one pair alone
  (their chain floors) on the card;
- ``stress_bigreads``: long reads (inserts 1-5 kb, up to 30 copies)
  through the pipeline twice, with the launch, padding and host-route
  counters (a copy of ``tools/stress_bigreads.py``);
- ``poa_stress``: clean and chimera-heavy sets in interleaved rounds,
  the share routed to the POA consensus and the throughput verdict (a
  copy of ``tools/poa_stress.py``).

``stress_bigreads`` and ``poa_stress`` take the backend as an argument:
``cuda`` (the default), ``cpu`` or ``numpy``.

Each runs as ``python -m c3poa_tpu_torch.tools.<name>``; the probes run
on the card unless ``--device cpu`` is passed.
"""
