"""zero_tpu_torch: the PyTorch/CUDA port of zero_tpu for NVIDIA Hopper.

A second package beside ``zero_tpu`` (the JAX reference, which it never
imports). Module names mirror the JAX package so that each counterpart is
easy to find:
  config.py / vocab.py           config & vocabulary (copies)
  data.py / pipeline.py          host data pipeline (copies); native/
                                 the C++ corpus tokeniser (a copy)
  audio.py                       log-mel frontend, speech dataset (copy)
  dtypes.py                      precision policy
  ops/                           tensor ops; ops/kernels + csrc/ hold the
                                 hand-written CUDA kernels
  models/                        model zoo (registry by name)
  rnns/                          RNN cells and time loops of the RNN models
  search.py                      beam search (and the pair search)
  train_step.py lrs.py           train step (Adam, clipping, EMA), LR
                                 schedules
  saver.py recorder.py           checkpoints in the JAX npz layout, resume
                                 bookkeeping
  train.py evalu.py metric.py    train/eval/score loops, decode loop, BLEU
                                 (metric.py: also detokenized BLEU, chrF,
                                 OTEM, UTEM and their CLI)
  run.py                         CLI (``--mode train|test|score|ensemble``)
  scripts/                       profilers of the card, offline tools

Ported so far: training, scoring and serving of all fifteen of the JAX
package's models on one device (models/__init__.py). Importing the
package registers them.
"""

from zero_tpu_torch import models  # noqa: F401  (registers the models)

__version__ = "0.1.0"
