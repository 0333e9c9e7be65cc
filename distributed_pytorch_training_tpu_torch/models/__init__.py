"""Models. Importing this package registers every ported model."""

from .bert import BertForMaskedLM  # registers bert_base
from .gpt2 import GPT2LMHead  # registers gpt2_124m / gpt2_355m
from .gpt2_pipe import GPT2PipeLMHead
from .moe import GPT2MoELMHead  # registers gpt2_moe
from .registry import get_model, register_model
from .resnet import ResNet  # registers resnet18 / resnet50
from .vit import ViT  # registers vit_b16

__all__ = ["BertForMaskedLM", "GPT2LMHead", "GPT2MoELMHead",
           "GPT2PipeLMHead", "ResNet", "ViT", "get_model", "register_model"]
