"""Model zoo of the port: name registry of seq2seq models (counterpart of
``zero_tpu/models``). Importing this package registers every ported model:
``transformer``, ``transformer_rpr``, ``transformer_rela``,
``transformer_aan``, ``transformer_fuse``, ``transformer_l0drop``,
``transformer_fixup``, ``transformer_moe``, ``transformer_multilingual``,
``transformer_clsr``, ``transformer_ibdecoder``, ``transformer_afs`` and
the RNN models ``rnnsearch``, ``deepnmt`` and ``rnnsearch_deepatt``: all
15 of base.JAX_MODELS, the JAX package's models."""

from zero_tpu_torch.models.base import ModelSpec, get_model, model_register  # noqa: F401

# import for registration side effects
from zero_tpu_torch.models import deepnmt  # noqa: F401
from zero_tpu_torch.models import rnnsearch  # noqa: F401
from zero_tpu_torch.models import rnnsearch_deepatt  # noqa: F401
from zero_tpu_torch.models import transformer  # noqa: F401
from zero_tpu_torch.models import transformer_aan  # noqa: F401
from zero_tpu_torch.models import transformer_afs  # noqa: F401
from zero_tpu_torch.models import transformer_clsr  # noqa: F401
from zero_tpu_torch.models import transformer_fixup  # noqa: F401
from zero_tpu_torch.models import transformer_fuse  # noqa: F401
from zero_tpu_torch.models import transformer_ibdecoder  # noqa: F401
from zero_tpu_torch.models import transformer_l0drop  # noqa: F401
from zero_tpu_torch.models import transformer_moe  # noqa: F401
from zero_tpu_torch.models import transformer_multilingual  # noqa: F401
from zero_tpu_torch.models import transformer_rela  # noqa: F401
from zero_tpu_torch.models import transformer_rpr  # noqa: F401
