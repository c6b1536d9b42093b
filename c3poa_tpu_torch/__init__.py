"""c3poa_tpu_torch — the c3poa consensus engine on PyTorch and CUDA.

A second package beside ``c3poa_tpu`` (the JAX reference, which it is
held against).  The framework-free host code — ``pipeline.run``,
``pipeline.segment``, ``pipeline.backend``, ``consensus``, ``native``,
``ref``, ``io``, ``sim`` and ``utils`` — is imported from ``c3poa_tpu``
as it is; this package supplies the device half:

- ``kernels.sw_profile`` — splint score profiles (hand-written CUDA
  kernel ``csrc/profile.cu`` + plain torch version)
- ``kernels.smooth`` / ``kernels.peaks`` / ``kernels.locate`` — the
  fused locate step in torch ops
- ``kernels.banded`` — banded affine-gap forward pass and path walk
  (CUDA kernels in ``csrc/banded.cu`` + plain torch versions)
- ``pipeline.torch_backend.TorchBackend`` — the backend object that
  ``run_pipeline`` drives
- ``cli`` — ``python -m c3poa_tpu_torch.cli``

Nothing here imports ``jax``.
"""

__version__ = "0.1.0"
