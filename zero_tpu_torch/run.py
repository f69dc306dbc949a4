"""CLI entry point of the port: config merge, vocab load, mode dispatch.

  python -m zero_tpu_torch.run --mode {train,test,score} --config FILE \
      --parameters k=v,...

Counterpart of ``zero_tpu/run.py``. Merge priority: command line > saved
param.json > config file > defaults. Runs on ``device`` (default "cuda";
``--parameters device=cpu`` for the CPU). ``--mode ensemble`` is a later
slice and raises.
"""

from __future__ import annotations

import argparse
import logging
import os
import random
import time

import numpy as np

from zero_tpu_torch import train as graph
from zero_tpu_torch.config import (default_config, merge_params,
                                   save_parameters)
from zero_tpu_torch.models.common import check_ported
from zero_tpu_torch.recorder import Recorder
from zero_tpu_torch.vocab import Vocab

log = logging.getLogger("zero_tpu_torch")

_LATER = {
    "ensemble": "a later serving slice (ensemble decoding)",
}


def setup_recorder(params):
    """Attach a (possibly resumed) Recorder."""
    recorder = Recorder()
    recorder.bad_counter = 0
    recorder.estop = False
    recorder.lidx = -1
    recorder.step = 0
    recorder.epoch = 1
    recorder.lrate = params.lrate
    recorder.history_scores = []
    recorder.valid_script_scores = []

    record_path = os.path.abspath(
        os.path.join(params.output_dir, "record.json"))
    if os.path.exists(record_path) and params.train_continue:
        recorder.load_from_json(record_path)

    params.add_param("recorder", recorder)
    return params


def print_parameters(params):
    log.info("The Used Configuration:")
    for k, v in sorted(params.values().items()):
        log.info("%s\t%s", str(k).ljust(30), str(v))


def load_vocabs(params):
    start = time.time()
    params.src_vocab = Vocab(params.src_vocab_file)
    params.tgt_vocab = Vocab(params.tgt_vocab_file)
    log.info("Loaded vocab: src %d, tgt %d in %.2f s",
             params.src_vocab.size(), params.tgt_vocab.size(),
             time.time() - start)
    return params


def main(argv=None):
    """Run one mode. Returns train()'s summary dict (--mode train),
    evaluate()'s (--mode test) or scorer()'s (scores, ppl) (--mode
    score)."""
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")

    parser = argparse.ArgumentParser("zero_tpu_torch")
    parser.add_argument("--config", default="",
                        help="additional mergeable parameter file")
    parser.add_argument("--parameters", default="",
                        help="command-line refinable parameters k=v,...")
    parser.add_argument("--ensemble_dirs", default="",
                        help="';'-separated model dirs for ensemble")
    parser.add_argument("--name", default="model")
    parser.add_argument("--mode", default="train",
                        choices=["train", "test", "score", "ensemble"])
    args = parser.parse_args(argv)
    if args.mode in _LATER:
        raise NotImplementedError(
            "--mode %s is not ported to zero_tpu_torch yet: it comes with %s"
            % (args.mode, _LATER[args.mode]))

    params = default_config()
    params = merge_params(params, args.config, args.parameters)
    if args.mode in ("train", "score"):
        check_ported(params)
    random.seed(params.random_seed)
    np.random.seed(params.random_seed)
    device = graph.device_of(params)
    log.info("zero_tpu_torch on %s", device)

    params = load_vocabs(params)
    print_parameters(params)
    if args.mode == "train":
        save_parameters(params, params.output_dir)
        params = setup_recorder(params)
        return graph.train(params)
    if args.mode == "score":
        return graph.scorer(params)
    return graph.evaluate(params)


if __name__ == "__main__":
    main()
