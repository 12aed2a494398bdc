"""Machine-local environment settings (the port's own copy of
``dbsr_tpu/environment.py``).

Paths live in a JSON file (``DBSR_TPU_ENV``, default
``~/.dbsr_tpu/env.json``); each entry can be overridden by a
``DBSR_TPU_<KEY>`` environment variable (``DBSR_TPU_WORKSPACE_DIR``, ...).
The workspace defaults to ``workspace/`` beside the file. Unlike the JAX
package, the port only reads the file and never creates it.
"""

from __future__ import annotations

import dataclasses
import json
import os


@dataclasses.dataclass
class EnvSettings:
    workspace_dir: str = ""  # checkpoints + logs
    tensorboard_dir: str = ""
    pretrained_nets_dir: str = ""
    zurichraw2rgb_dir: str = ""
    burstsr_dir: str = ""
    synburstval_dir: str = ""


_ENV_KEYS = tuple(f.name for f in dataclasses.fields(EnvSettings))


def env_settings() -> EnvSettings:
    path = os.environ.get("DBSR_TPU_ENV",
                          os.path.expanduser("~/.dbsr_tpu/env.json"))
    data = {}
    if os.path.exists(path):
        with open(path) as f:
            data = json.load(f)
    for k in _ENV_KEYS:
        override = os.environ.get(f"DBSR_TPU_{k.upper()}")
        if override:
            data[k] = override
    if not data.get("workspace_dir"):
        data["workspace_dir"] = os.path.join(os.path.dirname(path),
                                             "workspace")
    if not data.get("tensorboard_dir"):
        data["tensorboard_dir"] = os.path.join(data["workspace_dir"],
                                               "tensorboard")
    return EnvSettings(**{k: data.get(k, "") for k in _ENV_KEYS})


class Settings:
    """Open settings container: ``env`` plus whatever the config sets."""

    def __init__(self):
        self.env = env_settings()

    def __repr__(self):
        return f"Settings({self.__dict__})"
