"""xequinet-torch: the PyTorch / CUDA port of xequinet-tpu.

A second package beside ``xequinet_tpu`` (the JAX reference, which it
never imports).  Plain tensor code is PyTorch; every Pallas TPU kernel on
a ported path is a CUDA C++ kernel for Hopper (``csrc/``), built at first
use with ``nvcc`` and bound with ``ctypes``.  Entry points run on the
card unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
