"""PyTorch/CUDA port of the VC-ASGD system (the JAX package ``repro`` is
the reference it is held against).

The package mirrors ``repro``'s module paths.  It imports torch, numpy
and the standard library only.  Every entry point runs on the card
(``device="cuda"``) unless the caller asks for ``"cpu"``; the hand-written
CUDA kernels (``kernels/csrc/``: the flat-bus updates, the int8 codec,
the sparse-body pack and flash attention) are built at first use, never
at import.
"""
