"""Evaluators of the seg eval, numpy on the host: semantic mIoU, panoptic
PQ, instance AP."""

from .instance import InstanceAPEvaluator  # noqa: F401
from .panoptic import PanopticEvaluator  # noqa: F401
from .semseg import SemSegEvaluator  # noqa: F401
