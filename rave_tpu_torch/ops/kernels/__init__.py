"""Hand-written CUDA kernels of the port, each beside its plain twin.

``KERNELS`` lists every kernel so that a driver can build them together
(:func:`~rave_tpu_torch.ops.kernels.build.build_all`) and read or reset
their launch counts.
"""

from .ci1_conv import (DX as CI1_CONV_DX, DX_BF16 as CI1_CONV_DX_BF16,
                       FORWARD as CI1_CONV_FORWARD,
                       FORWARD_BF16 as CI1_CONV_FORWARD_BF16)
from .residual_unit import (KERNEL as RESIDUAL_UNIT,
                            KERNEL_BF16 as RESIDUAL_UNIT_BF16)

KERNELS = [RESIDUAL_UNIT, CI1_CONV_FORWARD, CI1_CONV_DX, RESIDUAL_UNIT_BF16,
           CI1_CONV_FORWARD_BF16, CI1_CONV_DX_BF16]
