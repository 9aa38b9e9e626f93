"""Architecture registry: ``--arch <id>`` resolution for the port's
launchers.

Counterpart of ``repro.configs.registry`` over the architectures the port
runs.  Only llama3.2-1b so far: the other nine of the JAX registry need
layer kinds or features the port has not taken over yet (ROADMAP Queue 1
item 14)."""
from __future__ import annotations

import importlib

_MODULES = {
    "llama3.2-1b": "repro_torch.configs.llama32_1b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(name: str):
    return importlib.import_module(_MODULES[name]).config()


def get_reduced(name: str):
    return importlib.import_module(_MODULES[name]).reduced()
