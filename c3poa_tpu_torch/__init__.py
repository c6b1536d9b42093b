"""c3poa_tpu_torch — the c3poa consensus engine on PyTorch and CUDA.

A second package beside ``c3poa_tpu`` (the JAX reference, which it is
held against) that imports nothing of it.  The framework-free host code
is this package's own copy of the JAX package's, module for module at
the same relative paths (``constants``, ``utils``, ``io``, ``ref``,
``consensus``, ``pipeline/{backend,segment,run,postprocess}``, ``native``
with its C sources in ``native_src/``, and ``sim``); tests hold each copy
to its original.  The device half:

- ``kernels.sw_profile`` — splint score profiles (hand-written CUDA
  kernel ``csrc/profile.cu`` + plain torch version)
- ``kernels.smooth`` / ``kernels.peaks`` / ``kernels.locate`` — the
  fused locate step in torch ops
- ``kernels.banded`` — banded affine-gap forward pass and path walk
  (CUDA kernels in ``csrc/banded.cu`` + plain torch versions)
- ``kernels.adapters`` — adapter hits for postprocessing (CUDA kernel
  ``csrc/adapters.cu`` + plain torch version)
- ``kernels.probes`` — the two TPU probes' counterparts (CUDA kernels
  ``csrc/int16_probe.cu`` and ``csrc/floor_probe.cu`` + plain torch
  versions), run by ``tools.int16_probe`` and ``tools.floor_probe``
- ``tools`` — the probes' entry points and copies of
  ``c3poa_tpu/tools/`` (``make_example``, ``demux_nextera_tso``)
- ``pipeline.torch_backend.TorchBackend`` — the backend object that
  ``run_pipeline`` and ``run_postprocess`` drive
- ``cli`` / ``cli_postprocess`` — ``python -m c3poa_tpu_torch.cli`` and
  ``python -m c3poa_tpu_torch.cli_postprocess``

Nothing here imports ``jax``.
"""

__version__ = "0.1.0"
