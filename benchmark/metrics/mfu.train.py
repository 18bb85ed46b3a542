"""mfu.train: ``benchmark.readers.mfu``, the work being the regressor's forward and backward, both SMPL passes and the loss, per crop."""

from benchmark.readers import mfu as read  # noqa: F401
