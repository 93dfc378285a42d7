"""The port's operations: the kernel wrappers (``coattn``, ``flash``,
``milpool``, ``gather``, built from ``csrc/`` by ``kernels``) and the layers
built on them.

Importing the package makes one call of torch's CPU ``tanh`` on 8 elements,
on the importing thread alone. torch evaluates ``tanh``, ``exp``, ``log`` and
other unary functions on the CPU through MKL's vector math library, in
2048-element chunks over its OpenMP threads. Where a fresh process's first
such call ran on several threads at once, some of the threads have computed
their chunks less accurately (``tanh`` up to 5e-5 off, against 3.2e-8 on every
later call), and a first call made on one thread beforehand has kept it from
happening (``tests/torch_vml_first_call.py`` counts both). The call keeps the
port's CPU path, the plain versions that the kernels are held to, exact from
its first call.
"""

import torch as _torch

_torch.tanh(_torch.zeros(8))
