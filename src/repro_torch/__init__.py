"""HUGE² on PyTorch and CUDA: the port of ``repro`` to an NVIDIA Hopper card.

The package mirrors ``src/repro/``'s layout (``core/``, ``kernels/``,
``models/``, ``serving/``) so each module has an obvious counterpart, and
keeps the JAX package's NHWC/HWIO layouts and superpack row order at its
public functions.  It imports ``torch``, numpy and the standard library only.

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``; without a card and without that argument they raise.
"""
