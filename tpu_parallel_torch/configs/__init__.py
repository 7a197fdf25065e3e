"""Training configs of the port: the counterparts of the repo's ``configs/``.

:func:`get_config` takes a config's name (``gpt2_125m_corpus``) or a path
whose file name is one (``configs/gpt2_125m_corpus.py``) and returns a
plain dict with the JAX config's keys and values.  :func:`override` applies
one ``--config.<dotted key>=<value>`` on a declared key, typed from the
declared default as ``ml_collections`` does.  A config the port could
not run would raise ``NotImplementedError`` naming the ROADMAP item that
brings it (``UNPORTED``; every shipped config runs).
"""

from __future__ import annotations

import copy
import importlib
import os
from typing import Any, Dict

from tpu_parallel_torch.configs.common import PLACEHOLDER_TYPES, SEQ2SEQ_PLACEHOLDER_TYPES

CONFIGS = ("bert_base_mlm", "gpt2_125m_dp", "gpt2_125m_tp", "gpt2_125m_corpus",
           "gpt2_125m_long", "gpt2_350m_pp", "gpt2_moe_ep", "llama_1b_3d", "mlp_dp_cpu",
           "t5_small_s2s", "tiny_3d_cpu")

# the repo's other configs -> what the port lacks to run them (none)
UNPORTED: Dict[str, str] = {}


def get_config(name_or_path: str) -> Dict[str, Any]:
    """The config dict named by ``name_or_path`` (a fresh copy)."""
    name = os.path.basename(name_or_path)
    if name.endswith(".py"):
        name = name[:-3]
    if name in UNPORTED:
        raise NotImplementedError(f"config {name!r} needs {UNPORTED[name]}")
    if name not in CONFIGS:
        raise KeyError(f"config {name!r}: the port has {CONFIGS}")
    module = importlib.import_module(f"tpu_parallel_torch.configs.{name}")
    return copy.deepcopy(module.get_config())


_TRUE = ("true", "t", "1", "yes", "y")
_FALSE = ("false", "f", "0", "no", "n")


def _parse(text: str, kind: type, key: str):
    if kind is bool:
        low = text.strip().lower()
        if low in _TRUE:
            return True
        if low in _FALSE:
            return False
        raise ValueError(f"--config.{key}={text!r}: not a bool")
    if kind is int:
        return int(text)
    if kind is float:
        return float(text)
    if kind is str:
        return text
    raise ValueError(f"--config.{key}: a {kind.__name__} field cannot be set from the CLI")


# model overrides the port accepts beside each config's declared ones:
# FSDP runs as an override of a data-parallel config
FSDP_OVERRIDE_TYPES = dict(fsdp=bool, fsdp_min_size=int)


def override(config: Dict[str, Any], dotted: str, text: str) -> None:
    """Set ``config[a][b]...`` for ``dotted = "a.b..."`` to ``text`` parsed
    as the declared value's type (a ``model_overrides`` placeholder by its
    declared type).  Under ``model_overrides``, ``fsdp`` and
    ``fsdp_min_size`` may be set too (``fsdp=True`` on ``gpt2_125m_dp``).
    An undeclared key raises ``KeyError``."""
    *parents, leaf = dotted.split(".")
    node = config
    for part in parents:
        if not isinstance(node.get(part), dict):
            raise KeyError(f"--config.{dotted}: {part!r} is not a declared group")
        node = node[part]
    if leaf not in node and parents == ["model_overrides"] and leaf in FSDP_OVERRIDE_TYPES:
        node[leaf] = _parse(text, FSDP_OVERRIDE_TYPES[leaf], dotted)
        return
    if leaf not in node:
        raise KeyError(f"--config.{dotted}: not a declared field")
    current = node[leaf]
    if current is None:
        types = dict(PLACEHOLDER_TYPES, **SEQ2SEQ_PLACEHOLDER_TYPES)
        if parents != ["model_overrides"] or leaf not in types:
            raise KeyError(f"--config.{dotted}: a None field without a declared type")
        kind = types[leaf]
    else:
        kind = type(current)
    node[leaf] = _parse(text, kind, dotted)
