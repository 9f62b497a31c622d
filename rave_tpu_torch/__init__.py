"""PyTorch + CUDA port of ``rave_tpu`` for NVIDIA Hopper (H100).

The JAX package ``rave_tpu`` is the reference; this package imports none
of it (nor JAX).  Layout inside is channels-first ``(B, C, T)`` (the
``F.conv1d`` layout); the public entry points keep the JAX package's
shapes: audio ``(B, T, 1)``, latent ``(B, T_z, latent)``.

Entry points take an explicit ``device`` (default ``"cuda"``) and raise
when CUDA is absent unless the caller asked for ``"cpu"``.  Hand-written
kernels (``ops/kernels``) run on CUDA tensors; their plain PyTorch
versions run only on tensors the caller placed on the CPU.
"""

__version__ = "0.1.0"


def resolve_device(device="cuda"):
    """The ``torch.device`` an entry point runs on: ``"cuda"`` unless the
    caller asked for another.  Never falls back to the CPU by itself.
    (torch is imported here, not with the package, so that the data
    pipeline's worker processes start without it.)"""
    import torch
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    return dev
