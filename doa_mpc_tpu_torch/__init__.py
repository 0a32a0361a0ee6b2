"""doa_mpc_tpu_torch — the PyTorch/CUDA port of ``doa_mpc_tpu``.

Closed-loop real-time-iteration MPC for a unicycle robot among moving
obstacles, batched over thousands of scenarios. The module tree mirrors the
JAX package; plain tensor code is PyTorch on batch-first tensors. The two
TPU kernels are hand-written CUDA kernels for the H100: the whole
interior-point QP solve (``csrc/ip_solve.cu``, wrapped by
``ops/ip_fused.py``) and the batched Riccati solve that the interior-point
solver of ``ops/ip_qp.py`` can use (``csrc/riccati.cu``, wrapped by
``ops/riccati_fused.py``). Every entry point takes an explicit ``device``
(default ``"cuda"``).

Importing the package turns TF32 off for matmuls and cuDNN: the solver's f32
algebra needs full-precision products (the CUDA counterpart of the TPU's
bf16-pass overflow the JAX package guards against).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

from doa_mpc_tpu_torch.config import (  # noqa: E402,F401
    CostParams, SolverOptions, WorldSpec, default_cost_params,
)
