"""PyTorch/CUDA port of the spectral path tracer in ``simple_spectral_tpu``.

The layout mirrors the JAX package module for module.  Plain tensor code is
PyTorch; the closest-hit sweep runs through a CUDA kernel written for Hopper
(``csrc/intersect_best_key.cu``, wrapped by ``render/intersect_pallas.py``).
The package imports neither ``jax`` nor ``simple_spectral_tpu``.

Matmul precision: the JAX package computes its colour contractions at
``Precision.HIGHEST`` (full f32).  TF32 would keep only ~3 decimal digits,
so both TF32 switches are turned off here, for matmuls and for cuDNN.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on.  Defaults to the card; a CUDA
    device without a card raises instead of falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev
