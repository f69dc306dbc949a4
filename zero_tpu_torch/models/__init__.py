"""Model zoo of the port: name registry of seq2seq models (counterpart of
``zero_tpu/models``). Importing this package registers every ported model:
``transformer``, ``transformer_rpr``, ``transformer_rela`` and
``transformer_aan`` (4 of the JAX package's 15)."""

from zero_tpu_torch.models.base import ModelSpec, get_model, model_register  # noqa: F401

# import for registration side effects
from zero_tpu_torch.models import transformer  # noqa: F401
from zero_tpu_torch.models import transformer_aan  # noqa: F401
from zero_tpu_torch.models import transformer_rela  # noqa: F401
from zero_tpu_torch.models import transformer_rpr  # noqa: F401
