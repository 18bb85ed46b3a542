from spec_tpu_torch.losses.aux import (  # noqa: F401
    joints_mse_loss,
    pixelwise_cross_entropy,
)
from spec_tpu_torch.losses.camcalib import (  # noqa: F401
    camera_regressor_loss,
    cross_entropy_loss,
    kl_one_hot_loss,
    softargmax_biased_l2_loss,
    softargmax_l2_loss,
)
from spec_tpu_torch.losses.hmr import (  # noqa: F401
    HMRLossConfig,
    gaussian_nll,
    hmr_cam_loss,
    hmr_loss,
    keypoint_3d_loss,
    projected_keypoint_loss,
    shape_loss,
    smpl_param_loss,
    smpl_param_loss_uncertainty,
)
