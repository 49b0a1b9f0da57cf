from .convert import load_jax_params  # noqa: F401
from .gpt import (GPTConfig, GPTForCausalLM, GPTModel,  # noqa: F401
                  GPTPretrainingCriterion, gpt_1p3b, gpt_medium, gpt_small,
                  gpt_tiny)
