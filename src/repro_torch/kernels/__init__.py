"""Hand-written Hopper kernels of the port, one package per reference kernel
family (``repro.kernels.*``): the CUDA source under ``csrc/``, the ctypes
wrapper (``kernel.py``), its plain PyTorch version (``ref.py``) and the
dispatcher the rest of the port calls (``ops.py``)."""
