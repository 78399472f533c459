"""opengaussian-tpu, PyTorch + CUDA port.

The second package of the repository: the render path and the whole
training schedule of `opengaussian_tpu` (stages 0, 1, 2.1, 2.2 and 3, with
checkpoints), written in PyTorch for an NVIDIA Hopper GPU. Plain tensor code
(projection, binning, SH, SSIM, k-means, the sweeps, Adam, densification,
I/O) is PyTorch; the rasterizer's kernels that `opengaussian_tpu` runs in
Pallas (the forward blend, its backward replays, the per-splat gradient
sum, and their dense-layout forms) are CUDA C++ kernels under `csrc/`,
built with nvcc at first use and loaded through ctypes.

Entry points run on `cuda` unless the caller passes `device="cpu"`; they
never fall back to the CPU on their own. On a CPU tensor every kernel
wrapper runs the kernel's plain PyTorch version, which is how the tests
hold the port against the JAX package.
"""

__version__ = "0.1.0"
