"""rovr_torch: the PyTorch/CUDA port of rovr_tpu, for NVIDIA Hopper (H100).

The JAX package `rovr_tpu` is the reference; this package keeps its module
and public function names so each counterpart is easy to find, and imports
neither JAX nor anything of `rovr_tpu`. Entry points run on CUDA unless the
caller passes `device="cpu"`. The hand-written kernels live in `csrc/` and
are compiled with nvcc at first use (`ops/cuda_build.py`).
"""
