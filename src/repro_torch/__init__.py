"""PathEnum on PyTorch and CUDA: the port of ``repro`` to an NVIDIA H100.

``repro`` (JAX, Pallas kernels for the TPU) stays the reference; this
package runs the same query pipeline with hand-written CUDA kernels for
Hopper (``kernels/csrc``) and plain PyTorch around them.  It imports
neither ``jax`` nor ``repro``.  Its entry points run on the card
(``device="cuda"``) unless the caller asks for the CPU.
"""
