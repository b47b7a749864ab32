"""PyTorch + CUDA port of the integerized system: serving, and the QAT
training that precedes integerization.

The JAX package ``repro`` is the reference; this package keeps its
subpackage and module names (``core/``, ``kernels/``, ``layers/``,
``models/``, ``optim/``, ``data/``, ``runtime/``, ``launch/``,
``configs/``, ``distributed/``) and never imports it
(or JAX).  Entry points run on the card (``device="cuda"``) unless the
caller asks for the CPU.
"""
