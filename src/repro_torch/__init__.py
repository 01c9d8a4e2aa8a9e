"""PyTorch + CUDA port of the HitGNN runtime (``repro``) for an NVIDIA H100.

The JAX package ``repro`` is the reference; this package mirrors its module
paths (``repro_torch.core.trainer`` is the counterpart of
``repro.core.trainer``) and imports nothing of it, nor JAX. Host modules
are bitwise copies of their counterparts (same numpy RNG streams, so both
packages sample the same batches and build the same layouts from a seed);
the device step is PyTorch, and every TPU kernel on the ported path is a
hand-written CUDA kernel (``kernels/csrc``).

Entry points run on the card: ``device=None`` means ``"cuda"``, and without
CUDA they raise unless the caller passes ``device="cpu"``.
"""
