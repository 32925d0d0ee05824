"""The reference's YAML configs (counterpart of ``sstem_tpu/compat/config.py``:
``AttrDict``, ``NoneDict``, ``load_sff_config`` and ``load_sp_config``).

  * SFF: nested YAML resolved by *name* against a config directory, or
    given by path, and wrapped in attribute-access dicts
    (AttrDict(yaml.load(open('./config/'+name+'.yaml'))),
    sff_scripts_interp/main_ms.py:301-302).
  * SP: flat YAML loaded by *path* with default-None access
    (sp_scripts_train/utils/option.py:8-43).
"""

import os

import yaml


class AttrDict(dict):
    """Attribute access over nested dicts; missing keys raise (SFF dialect)."""

    def __getattr__(self, name):
        try:
            v = self[name]
        except KeyError as e:
            raise AttributeError(name) from e
        if isinstance(v, dict) and not isinstance(v, AttrDict):
            v = AttrDict(v)
            self[name] = v
        return v

    def __setattr__(self, name, value):
        self[name] = value


class NoneDict(dict):
    """Missing keys yield None (SP dialect helper, utils/util.py:22-34)."""

    def __getattr__(self, name):
        v = self.get(name)
        if isinstance(v, dict) and not isinstance(v, NoneDict):
            v = NoneDict(v)
            self[name] = v
        return v

    def __setattr__(self, name, value):
        self[name] = value


def load_sff_config(name, config_dir="./config"):
    """Load an SFF config by name (or direct path) -> AttrDict."""
    path = name if os.path.isfile(name) else os.path.join(
        config_dir, name + ".yaml"
    )
    with open(path) as f:
        cfg = AttrDict(yaml.safe_load(f))
    cfg.path = path
    return cfg


def load_sp_config(path):
    """Load an SP flat config by path -> NoneDict (missing keys -> None)."""
    with open(path) as f:
        return NoneDict(yaml.safe_load(f))
