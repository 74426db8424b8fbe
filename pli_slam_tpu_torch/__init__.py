"""PyTorch + CUDA port of `pli_slam_tpu` for NVIDIA Hopper (H100).

The JAX package beside this one is the reference: every module here keeps
its counterpart's module path, function names, padded fixed-capacity
array layout and dtypes (±1 int8 descriptors, float32 geometry, int32 ids
padded with -1, bool masks), so parity tests can compare slot by slot.

The port imports `torch` and numpy, never `jax`, and nothing of the JAX
package: it keeps its own copy of what it needs (`utils/config.py`), and
`utils.convert` carries settings and state across as plain dicts and arrays.

Precision: the reference asks XLA for `Precision.HIGHEST` on every
geometric contraction (orb.py:209, matching.py:103, ba.py:43), so TF32
is switched off for both matmul and cuDNN here.
"""

import torch

from pli_slam_tpu_torch.utils.config import SlamConfig  # noqa: F401  (re-export)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
