from .build import Sam, SamConfig, SAM_VARIANTS, build_sam, sam_model_registry  # noqa: F401
from .image_encoder import ImageEncoderViT  # noqa: F401
from .mask_decoder import MaskDecoder, TwoWayTransformer  # noqa: F401
from .prompt_encoder import PromptEncoder  # noqa: F401
