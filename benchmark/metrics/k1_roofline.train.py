"""k1_roofline.train: ``benchmark.readers.k1_roofline``, the work being two passes a step (the ground-truth and the predicted meshes) over the batch."""

from benchmark.readers import k1_roofline as read  # noqa: F401
