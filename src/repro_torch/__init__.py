"""PyTorch + CUDA port of the ``repro`` package, for one NVIDIA H100.

The JAX package ``repro`` stays the reference; this package mirrors its
layout (``configs/``, ``kernels/``, ``model/``, ``serve/``, ``launch/``)
and imports nothing of it, nor JAX.  Entry points run on the card
(``device=None`` means ``"cuda"``) and run on the CPU only when the caller
passes ``device="cpu"``, as the CPU tests do.  On CPU tensors each kernel
wrapper uses its plain PyTorch version; on CUDA tensors it launches the
hand-written kernel or raises.
"""
