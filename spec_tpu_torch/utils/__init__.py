from spec_tpu_torch.utils import paths  # noqa: F401
from spec_tpu_torch.utils.config import (  # noqa: F401
    CfgNode,
    camcalib_default_config,
    get_grid_search_configs,
    run_grid_search_experiments,
    spec_default_config,
)
from spec_tpu_torch.utils.profiling import (  # noqa: F401
    StepTimer,
    annotate,
    nan_guard,
    set_seed,
    trace,
)
