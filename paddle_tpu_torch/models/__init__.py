from .bert import (BertConfig, BertEmbeddings,  # noqa: F401
                   BertForPretraining, BertModel, bert_pretrain_loss)
from .convert import (bridge_ctr_params, load_jax_params, load_jax_pipeline_params,  # noqa: F401
                      pipeline_params_as_stacked)
from .deepfm import DeepFM, deepfm_loss  # noqa: F401
from .gpt import (GPTConfig, GPTForCausalLM, GPTLMHead,  # noqa: F401
                  GPTModel, GPTPretrainingCriterion, build_gpt_pipeline,
                  gpt_1p3b, gpt_medium, gpt_small, gpt_tiny)
from .wide_deep import WideDeep  # noqa: F401
