"""PyTorch/CUDA port of robir_tpu.

A second package beside the JAX one (``robir_tpu``), which stays the
reference it is tested against. It imports ``torch`` and nothing of JAX or
of ``robir_tpu``. It runs the stage-1 train step (NeuS, with or without
the NeRF background shell; the hash-grid NeuS; VNeRF and MipNeRF under the
mip renderer; on blender, NeuS, LLFF and Multicam scenes) and the mesh
export, the texture bake (host C++ and numpy, ``texture/``), the stage-2
Norm, Vis, PBR and CESR train steps (Vis, PBR and CESR also in IDR mode),
and after them relighting, the SG envmap fit, the texture-map export and
the import of reference checkpoints, from the command line as the JAX
package does (``python -m robir_tpu_torch.cli``, ``cli.py``) on scenes
read from disk; it reads and writes the JAX package's checkpoints, and
``tools/shadow_pipeline.py`` scores the whole chain on the procedural
shadow scene. ``core/mesh.py`` spreads one scene's stage-1 and stage-2
steps over several GPUs, one process a rank under ``torch.distributed``
(``mesh=``). Its dense trunks (the SDF trunk, the CESR normal net) and
the grid tracer's march run through hand-written CUDA kernels for Hopper
(``csrc/``, built with ``nvcc`` at first use), whose plain PyTorch
versions serve CPU tensors only.
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
