from . import datasets  # noqa: F401
from .checkpoint import (  # noqa: F401
    AsyncCheckpointManager,
    restore_checkpoint,
    save_checkpoint,
)
from .debug import (  # noqa: F401
    assert_finite,
    check_2norm,
    checkify_errors,
    enable_nan_debugging,
    find_nonfinite,
    tensor_stats,
)
from .timing import KernelBench, device_loop_time  # noqa: F401
