"""Config composition and instantiation (counterpart of stoix_tpu/utils/config.py).

A copy of the JAX package's first-party Hydra/OmegaConf equivalent, kept here so
the port never imports the JAX package: `Config` (attribute-access nested
dict), YAML group composition from a root file's `defaults:` list, CLI
overrides (``group=name`` and ``a.b.c=value``) and `instantiate` of `_target_`
dotted paths. `default_config_dir()` points at the port's own config tree,
whose keys and values are the JAX package's with `_target_` re-pointed.

Example:

    config = compose(default_config_dir(), "default/anakin/default_ff_ppo.yaml",
                     ["env=identity_game", "system.gamma=0.99"])
"""

from __future__ import annotations

import copy
import importlib
import os
from typing import Any, Dict, List, Optional, Sequence

import yaml


class Config(dict):
    """A nested dict with attribute access. Always mutable ("struct off")."""

    def __getattr__(self, item: str) -> Any:
        try:
            return self[item]
        except KeyError as e:
            raise AttributeError(item) from e

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def __delattr__(self, key: str) -> None:
        del self[key]

    def __deepcopy__(self, memo: dict) -> "Config":
        return Config({k: copy.deepcopy(v, memo) for k, v in self.items()})

    @staticmethod
    def from_dict(d: Any) -> Any:
        if isinstance(d, dict):
            return Config({k: Config.from_dict(v) for k, v in d.items()})
        if isinstance(d, list):
            return [Config.from_dict(v) for v in d]
        return d

    def to_dict(self) -> Dict[str, Any]:
        def conv(v: Any) -> Any:
            if isinstance(v, dict):
                return {k: conv(x) for k, x in v.items()}
            if isinstance(v, list):
                return [conv(x) for x in v]
            return v

        return conv(self)


def _deep_merge(base: Dict[str, Any], overlay: Dict[str, Any]) -> Dict[str, Any]:
    """Merge overlay into base (overlay wins; dicts merge recursively)."""
    out = dict(base)
    for k, v in overlay.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _load_yaml(path: str) -> Dict[str, Any]:
    with open(path) as f:
        data = yaml.safe_load(f) or {}
    if not isinstance(data, dict):
        raise ValueError(f"Config file {path} must contain a mapping at top level")
    return data


def _resolve_group_file(config_dir: str, group: str, name: str) -> str:
    for candidate in (
        os.path.join(config_dir, group, f"{name}.yaml"),
        os.path.join(config_dir, group, name, "default.yaml"),
    ):
        if os.path.exists(candidate):
            return candidate
    raise FileNotFoundError(
        f"No config file for group '{group}' name '{name}' under {config_dir}"
    )


def _set_dotted(cfg: Dict[str, Any], dotted: str, value: Any) -> None:
    keys = dotted.split(".")
    node = cfg
    for k in keys[:-1]:
        if k not in node or not isinstance(node[k], dict):
            node[k] = {}
        node = node[k]
    node[keys[-1]] = value


def _parse_value(raw: str) -> Any:
    try:
        return yaml.safe_load(raw)
    except yaml.YAMLError:
        return raw


def compose(
    config_dir: str,
    root_file: str,
    overrides: Optional[Sequence[str]] = None,
) -> Config:
    """Compose a config from a root file's defaults list plus CLI overrides."""
    overrides = list(overrides or [])
    root_path = os.path.join(config_dir, root_file)
    root = _load_yaml(root_path)
    defaults: List[Any] = root.pop("defaults", [])

    # Group overrides (``env=pendulum``) redirect defaults-list entries; they
    # must be applied before files are loaded.
    group_overrides: Dict[str, str] = {}
    value_overrides: List[str] = []
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"Override '{ov}' must be key=value")
        key, raw = ov.split("=", 1)
        if "." not in key and any(
            isinstance(d, dict) and key in d for d in defaults
        ):
            group_overrides[key] = raw
        else:
            value_overrides.append(ov)

    merged: Dict[str, Any] = {}
    self_merged = False
    for entry in defaults:
        if entry == "_self_":
            merged = _deep_merge(merged, root)
            self_merged = True
            continue
        if not isinstance(entry, dict) or len(entry) != 1:
            raise ValueError(f"Unsupported defaults entry: {entry!r}")
        group, name = next(iter(entry.items()))
        name = group_overrides.get(group, name)
        path = _resolve_group_file(config_dir, group, str(name))
        content = _load_yaml(path)
        content.pop("defaults", None)
        merged = _deep_merge(merged, {group: content})
    if not self_merged:
        merged = _deep_merge(merged, root)

    for ov in value_overrides:
        key, raw = ov.split("=", 1)
        _set_dotted(merged, key, _parse_value(raw))

    return Config.from_dict(merged)


def default_config_dir() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")


def _import_target(target: str) -> Any:
    module_name, _, attr = target.rpartition(".")
    if not module_name:
        raise ValueError(f"_target_ '{target}' must be a dotted path")
    module = importlib.import_module(module_name)
    return getattr(module, attr)


def instantiate(cfg: Any, **kwargs: Any) -> Any:
    """Recursively build objects from configs containing `_target_` keys.

    - dicts with `_target_` become calls: target(**children, **kwargs)
    - `_partial_: true` returns functools.partial instead of calling
    - lists/dicts recurse; everything else passes through.
    """
    import functools

    if isinstance(cfg, dict):
        if "_target_" in cfg:
            target = _import_target(cfg["_target_"])
            partial = bool(cfg.get("_partial_", False))
            built = {
                k: instantiate(v)
                for k, v in cfg.items()
                if k not in ("_target_", "_partial_")
            }
            built.update(kwargs)
            if partial:
                return functools.partial(target, **built)
            return target(**built)
        return Config({k: instantiate(v) for k, v in cfg.items()})
    if isinstance(cfg, (list, tuple)):
        return [instantiate(v) for v in cfg]
    return cfg
