"""Models. Importing this package registers every ported model."""

from .gpt2 import GPT2LMHead  # registers gpt2_124m / gpt2_355m
from .registry import get_model, register_model
from .resnet import ResNet  # registers resnet18 / resnet50

__all__ = ["GPT2LMHead", "ResNet", "get_model", "register_model"]
