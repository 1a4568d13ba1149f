from repro_torch.optim.adamw import (  # noqa: F401
    AdamWConfig, init_state, update, global_norm, clip_by_global_norm,
)
from repro_torch.optim import schedules, compression  # noqa: F401
