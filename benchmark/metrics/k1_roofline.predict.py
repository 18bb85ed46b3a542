"""k1_roofline.predict: ``benchmark.readers.k1_roofline``, the work being one pass over each call's persons."""

from benchmark.readers import k1_roofline as read  # noqa: F401
