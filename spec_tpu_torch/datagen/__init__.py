"""Offline data generation (port of ``spec_tpu/datagen/``): Pano360
crops, AGORA merging, the synthetic rendered SPEC set and the Flickr
downloader. Host code; only ``spec_synth``'s SMPL runs on a device."""

from spec_tpu_torch.datagen.projection import (  # noqa: F401
    camera_rays,
    equirect_to_perspective,
    rays_to_equirect_uv,
    rotation_from_angles,
)
from spec_tpu_torch.datagen.pano_preprocessing import (  # noqa: F401
    preprocess_calib_data,
    sample_cam_params,
)
from spec_tpu_torch.datagen.scalenet import (  # noqa: F401
    generate_calibration_dataset,
    sample_scalenet_cam,
)
from spec_tpu_torch.datagen.pano_agora import (  # noqa: F401
    agora_vfov_from_focal,
    merge_pano_agora,
)
from spec_tpu_torch.datagen.spec_synth import (  # noqa: F401
    install_humanoid_smpl_assets,
    make_humanoid_smpl_raw,
    render_spec_synth_dataset,
)
