"""The reference's SFF YAML configs (counterpart of
``sstem_tpu/compat/config.py``: ``AttrDict`` and ``load_sff_config``).

An SFF config is nested YAML resolved by *name* against a config directory,
or given by path, and wrapped in attribute-access dicts
(AttrDict(yaml.load(open('./config/'+name+'.yaml'))),
sff_scripts_interp/main_ms.py:301-302).
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


def load_sff_config(name, config_dir="./config"):
    """Load an SFF config by name (or direct path) -> AttrDict."""
    path = name if os.path.isfile(name) else os.path.join(
        config_dir, name + ".yaml"
    )
    with open(path) as f:
        cfg = AttrDict(yaml.safe_load(f))
    cfg.path = path
    return cfg
