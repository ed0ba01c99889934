"""PyTorch/CUDA port of paddle_tpu for one NVIDIA H100.

The JAX package ``paddle_tpu`` is the reference: every module here
mirrors the path of its counterpart there (``ops/pallas/paged_attention.py``
-> ``ops/paged_attention.py``, ``inference/paged.py`` ->
``inference/paged.py``, ...).  The port imports torch and never jax or
``paddle_tpu``.  Its kernels are hand-written for Hopper: CUDA C++ under
``ops/csrc`` (built with nvcc at first use) and Triton.
"""
