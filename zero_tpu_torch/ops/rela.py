"""ReLA: rectified linear sparse attention.

Counterpart of ``zero_tpu/ops/rela.py``. The math lives in ops.attention
(``relu=True`` switches ``_attn_core`` to multiply-masking + ReLU, and
``gated_rms_norm`` is the stabilising epilogue); this module re-exports
those entry points under the reference's names.
"""

from zero_tpu_torch.ops.attention import (  # noqa: F401
    attn_train,
    cross_attn_precompute,
    cross_attn_step,
    gated_rms_norm,
    init_attention,
    self_attn_step,
)
