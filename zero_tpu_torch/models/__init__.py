"""Model zoo of the port: name registry of seq2seq models (counterpart of
``zero_tpu/models``). Importing this package registers every ported model:
``transformer`` and ``transformer_rpr``."""

from zero_tpu_torch.models.base import ModelSpec, get_model, model_register  # noqa: F401

# import for registration side effects
from zero_tpu_torch.models import transformer  # noqa: F401
from zero_tpu_torch.models import transformer_rpr  # noqa: F401
