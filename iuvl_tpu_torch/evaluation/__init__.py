"""Evaluators, numpy on the host: semantic mIoU, panoptic PQ, instance AP
(the seg eval), the interactive NoC / mIoU@k, and the vision-language
evals: grounding IoU, retrieval recall@k, captioning BLEU-4 / CIDEr-D,
classification top-k and VQA accuracy."""

from .captioning import CaptioningEvaluator  # noqa: F401
from .classification import ClassificationEvaluator  # noqa: F401
from .grounding import GroundingEvaluator  # noqa: F401
from .instance import InstanceAPEvaluator  # noqa: F401
from .interactive import InteractiveEvaluator  # noqa: F401
from .panoptic import PanopticEvaluator  # noqa: F401
from .retrieval import RetrievalEvaluator  # noqa: F401
from .semseg import SemSegEvaluator  # noqa: F401
from .vqa import VQAEvaluator  # noqa: F401
