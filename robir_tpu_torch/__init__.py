"""PyTorch/CUDA port of robir_tpu.

A second package beside the JAX one (``robir_tpu``), which stays the
reference it is tested against. It imports ``torch`` and nothing of JAX or
of ``robir_tpu``. It runs the stage-1 NeuS train step and the stage-2 CESR
train step; their dense trunks (the SDF trunk, the CESR normal net) run
through hand-written CUDA kernels for Hopper (``csrc/``, built with
``nvcc`` at first use), whose plain PyTorch versions serve CPU tensors
only.
"""

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for the CPU. Raises if CUDA is asked for and absent — never continues
    on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA was asked for but torch.cuda.is_available() "
                           "is False; pass device='cpu' to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device
