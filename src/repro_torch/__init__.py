"""PyTorch/CUDA port of the ``repro`` package for NVIDIA Hopper (H100).

The port mirrors ``repro``'s layout (``configs/``, ``api/``, ``core/``,
``kernels/``, ``nn/``, ``models/``, ``serve/``, ``launch/``) and imports
neither JAX nor ``repro``.  Its hot kernels are CUDA C++ under ``csrc/``,
built with ``nvcc`` and loaded with ``ctypes`` at their first CUDA call;
importing the package builds and loads nothing.
"""
