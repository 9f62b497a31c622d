"""The autograd receptive-field probe.

Port of ``rave_tpu/utils/receptive_field.py`` (the reference's
measurement, ``rave/core.py:190-226``): the gradient of the centre
output sample with respect to a zero input, whose support is the
receptive field.  An offline calibration of the analytic bound of
``valid_signal_crop`` (:func:`~rave_tpu_torch.train.loop.
receptive_field_frames`).
"""

from __future__ import annotations

import torch

from .. import resolve_device


def measure_receptive_field(apply_fn, T: int = 2 ** 15, batch: int = 1,
                            device="cuda") -> tuple[int, int]:
    """``(left, right)`` receptive field of ``apply_fn`` in input samples.

    ``apply_fn`` maps audio ``(B, T, 1)`` on ``device`` to ``(B, T', C)``
    deterministically.  ``T`` doubles until the gradient's support lies
    inside the input; a gradient that is zero everywhere raises."""
    device = resolve_device(device)
    while True:
        x = torch.zeros(batch, T, 1, device=device, requires_grad=True)
        y = apply_fn(x)
        (g,) = torch.autograd.grad(y[0, y.shape[1] // 2, 0], x)
        nz = torch.nonzero(g[0, :, 0]).flatten().cpu()
        if len(nz) == 0:
            raise RuntimeError("no gradient support -- wrong apply_fn?")
        if nz[0] > 0 and nz[-1] < T - 1:
            break
        T *= 2
    centre = T // 2
    return int(centre - nz[0]), int(nz[-1] - centre)
