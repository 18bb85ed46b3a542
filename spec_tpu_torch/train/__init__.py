from spec_tpu_torch.train.state import (  # noqa: F401
    TrainState,
    adam,
    create_train_state,
    lr_schedule,
    make_optimizer,
)
from spec_tpu_torch.train.steps import (  # noqa: F401
    make_camcalib_train_step,
    make_spec_train_step,
)
