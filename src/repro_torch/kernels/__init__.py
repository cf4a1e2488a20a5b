"""Hand-written CUDA kernels of the port, each beside its plain torch version.

``ops`` dispatches on the tensors' device (CPU: plain version, CUDA: the
kernel); ``_build`` compiles ``csrc/*.cu`` with ``nvcc`` on first launch.
"""
