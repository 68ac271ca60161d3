"""Device ops: tone mapping, the counter-based generator, and the kernels
(``ops.kernels``: each CUDA kernel's wrapper beside its plain torch
version)."""
