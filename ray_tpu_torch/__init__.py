"""ray_tpu_torch: the PyTorch/CUDA port of the JAX package's compute, for
one NVIDIA H100.

The layout follows the JAX package (``ops/``, ``models/``, ``train/``,
``llm/``, ``rllib/``) so each module has a named counterpart there. The
package imports only PyTorch and numpy. Its entry points run on CUDA
unless the caller passes ``device="cpu"`` (see ``device.py``).
"""
