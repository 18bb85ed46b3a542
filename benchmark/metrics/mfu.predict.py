"""mfu.predict: ``benchmark.readers.mfu``, the work being CamCalib on the calls' keyframes, the regressor and SMPL on their persons (padding not counted)."""

from benchmark.readers import mfu as read  # noqa: F401
