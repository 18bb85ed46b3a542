"""spec_tpu_torch.core.constants vs spec_tpu.core.constants: the port's
copy of each table it uses equals the JAX package's, value for value and
dtype for dtype."""

import numpy as np
import pytest

from spec_tpu.core import constants as JC
from spec_tpu_torch.core import constants as TC


@pytest.mark.parametrize('name', [
    'IMG_NORM_MEAN', 'IMG_NORM_STD', 'JOINT49_TO_SMPL54', 'SMPL_PARENTS',
    'EXTRA_VERTEX_JOINT_IDS', 'NUM_SMPL_JOINTS', 'NUM_SMPL_VERTICES',
    'NUM_BETAS', 'H36M_TO_J17', 'H36M_TO_J14', 'SMPL_JOINTS_FLIP_PERM',
    'SMPL_POSE_FLIP_PERM', 'J24_FLIP_PERM', 'J49_FLIP_PERM'])
def test_copied_table_matches_jax_package(name):
    got, want = getattr(TC, name), getattr(JC, name)
    assert type(got) is type(want)
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want
