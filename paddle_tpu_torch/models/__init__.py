from .gpt import GPT, GPTConfig, gpt_loss_fn

__all__ = ["GPT", "GPTConfig", "gpt_loss_fn"]
