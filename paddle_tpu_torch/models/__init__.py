from .gpt import GPT, GPTConfig

__all__ = ["GPT", "GPTConfig"]
