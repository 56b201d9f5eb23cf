"""xequinet-torch: the PyTorch / CUDA port of xequinet-tpu.

A second package beside ``xequinet_tpu`` (the JAX reference, which it
never imports).  Plain tensor code is PyTorch; every Pallas TPU kernel on
a ported path is a CUDA C++ kernel for Hopper (``csrc/``), built at first
use with ``nvcc`` and bound with ``ctypes``.  Entry points run on the
card unless the caller asks for the CPU.
"""

__version__ = "0.1.0"

import torch as _torch

# torch's CPU math library (MKL VML in torch 2.13.0+cpu) sets itself up on
# its first call.  When that first call runs on several threads at once,
# the threads that lose the race compute their share at reduced precision
# (relative errors up to 3e-4 in sin, cos, exp, sqrt and tanh; in 2-9% of
# fresh processes at 8 threads).  One single-element call, on this thread
# alone, does the set-up first.
_torch.sin(_torch.zeros(1))
