"""The LLaVA-style LLM stage (counterpart of ``iuvl_tpu/models/llm``)."""
from .llama import LlamaConfig, LlamaForCausalLM, build_llama  # noqa: F401
from .multimodal import beam_generate, greedy_generate, splice_image_features  # noqa: F401
