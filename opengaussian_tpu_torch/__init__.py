"""opengaussian-tpu, PyTorch + CUDA port.

The second package of the repository: the same render path as
`opengaussian_tpu`, written in PyTorch for an NVIDIA Hopper GPU. Plain
tensor code (projection, binning, SH, I/O) is PyTorch; the per-tile alpha
blend that `opengaussian_tpu` runs as a Pallas kernel is a CUDA C++ kernel
under `csrc/`, built with nvcc at first use and loaded through ctypes.

Entry points run on `cuda` unless the caller passes `device="cpu"`; they
never fall back to the CPU on their own. On a CPU tensor every kernel
wrapper runs the kernel's plain PyTorch version, which is how the tests
hold the port against the JAX package.
"""

__version__ = "0.1.0"
