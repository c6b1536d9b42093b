"""Device kernels of the port: plain torch versions and their hand-written
CUDA counterparts (``csrc/``), dispatched by the device of the tensors
they are given — the plain version for a CPU tensor, the CUDA kernel (or
an error) for a CUDA tensor.  Importing this package builds nothing.
"""
