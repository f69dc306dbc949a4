"""Shared helpers of the tests that hold zero_tpu_torch to zero_tpu: the
config translation and the weight bridge (JAX param tree -> torch module)."""

import numpy as np
import torch

from zero_tpu.saver import _flatten
from zero_tpu_torch import config as port_config_mod
from zero_tpu_torch.saver import params_from_flat


def port_config(cfg, **overrides):
    """The port's Config holding the same values as a JAX-package Config,
    on the CPU."""
    c = port_config_mod.default_config()
    for k, v in cfg.values().items():
        setattr(c, k, v)
    c.device = "cpu"
    for k, v in overrides.items():
        setattr(c, k, v)
    return c


def bridge(jax_tree, module):
    """Load a JAX param tree into a port module through the checkpoint key
    paths (saver._flatten) and params_from_flat; returns the module."""
    module.load_state_dict(params_from_flat(_flatten(jax_tree, "p"), "p"))
    return module


def t(x):
    """numpy/JAX array -> torch CPU tensor (copy)."""
    return torch.from_numpy(np.array(x))
