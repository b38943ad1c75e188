"""What belongs to one model type, one module a type, found by the
configuration's "model_type" (benchmark/models/<model_type lowercased>.py).

Each module defines, from the published definition of its model alone:

  factor_shape(config)         the logical shape of one row's factor weights
  slots_per_row(config)        the compulsory float32 slots of one touched
                               row (benchmark/floors.py)
  forward_flops(config, rows)  the forward pass's operations
                               (benchmark/floors.py)
  interaction(config, v, x, need_grad)
                               the plain reference's pairwise term and its
                               gradient (benchmark/reference/model.py)
  logical_view(rows, config, field_pad)
                               the program's stored factor rows seen in the
                               logical layout (benchmark/port.py)

None of them imports the program.  A new model type is a new file here.
"""

from __future__ import annotations

import importlib


def of(config: dict):
    """The module of the configuration's model type."""
    name = config["model_type"].lower()
    try:
        return importlib.import_module(f"benchmark.models.{name}")
    except ModuleNotFoundError as e:
        raise ValueError(f"no benchmark/models/{name}.py for model "
                         f"{config['model_type']!r}") from e
