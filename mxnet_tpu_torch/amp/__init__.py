"""mx.amp: automatic mixed precision (port of ``mxnet_tpu/amp``; parity:
python/mxnet/contrib/amp)."""
from .amp import (init, init_trainer, scale_loss, unscale,  # noqa: F401
                  convert_model, convert_hybrid_block, amp_active,
                  cast_inputs_for, cast_op, reset, health_stats,
                  reset_health_stats)
from .loss_scaler import LossScaler  # noqa: F401
from . import lists  # noqa: F401
