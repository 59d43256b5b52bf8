"""The program's model config for a configuration file: the port's
registered config of the same architecture, with the fields that the
configuration's kind sets (``program_fields``)."""

from __future__ import annotations

import dataclasses
from pathlib import Path

from pbench import spec


def program_config(conf: dict, root: Path = spec.ROOT):
    """``repro_torch``'s ``ModelConfig`` that runs ``conf``."""
    from repro_torch.configs import get_config

    kind = spec.reference(conf, root)
    fields = kind.program_fields(kind.shapes(conf), conf)
    return dataclasses.replace(get_config(conf["runs_as"]["arch"]), **fields)
