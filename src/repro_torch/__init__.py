"""PyTorch port of the nvPAX allocator for NVIDIA Hopper GPUs.

The package mirrors :mod:`repro` module for module (``core/``,
``core/solver/``, ``kernels/``, ``pdn/``, ``fleet/``, ``obs/``, ``power/``,
and of the data plane ``configs/``, ``models/``, ``training/``,
``sharding/``, ``launch/``) and is
held against it by the ``tests/test_torch_*.py`` parity tests.  It imports only ``torch``,
``numpy`` and the standard library.

Entry points take ``device=None``, which means ``cuda``; without a card the
caller must pass ``device="cpu"`` explicitly (see :func:`compat.resolve_device`).
On a CUDA tensor the kernel wrappers in :mod:`repro_torch.kernels` launch the
hand-written CUDA kernels; on a CPU tensor they run their plain PyTorch
versions.
"""
