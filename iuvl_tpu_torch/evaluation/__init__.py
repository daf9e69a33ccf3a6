"""Evaluators, numpy on the host: semantic mIoU, panoptic PQ, instance AP
(the seg eval) and the interactive NoC / mIoU@k."""

from .instance import InstanceAPEvaluator  # noqa: F401
from .interactive import InteractiveEvaluator  # noqa: F401
from .panoptic import PanopticEvaluator  # noqa: F401
from .semseg import SemSegEvaluator  # noqa: F401
