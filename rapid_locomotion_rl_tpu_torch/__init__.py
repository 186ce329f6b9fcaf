"""rapid_locomotion_rl_tpu_torch — the PyTorch/CUDA port of rapid_locomotion_rl_tpu.

The JAX package beside it stays the reference. This package keeps its
module names (``config``, ``models/``, ``ops/``, ``envs/``, ``learn/``,
``parallel/``, ``utils/``) and imports ``torch`` and ``numpy`` only. The physics step runs
as one hand-written CUDA kernel (``csrc/``, bound in
``ops/cuda_physics.py``) for tensors on the card, and as its plain PyTorch
version (``ops/soa_physics.py``) for tensors on the CPU.
"""

import os

ROOT_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

__version__ = "0.1.0"
