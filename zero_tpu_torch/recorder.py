"""Training-state recorder: JSON-persisted resume bookkeeping.

A copy of ``zero_tpu/recorder.py`` (the port imports nothing of the JAX
package). Counterpart of reference utils/recorder.py:11-24 (Nematus-inspired): a
free-form attribute bag serialised to record.json holding step, epoch,
local data index, learning rate, score history, and early-stop counters
(fields populated by run.setup_recorder, reference run.py:276-296).
"""

from __future__ import annotations

import json
import logging

log = logging.getLogger("zero_tpu_torch.recorder")


class Recorder:
    def load_from_json(self, file_name: str) -> None:
        log.info("Loading recorder file from %s", file_name)
        with open(file_name) as r:
            self.__dict__.update(json.load(r))

    def save_to_json(self, file_name: str) -> None:
        log.info("Saving recorder file into %s", file_name)
        with open(file_name, "w") as w:
            json.dump(self.__dict__, w, indent=2)
