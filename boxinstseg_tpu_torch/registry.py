"""String-keyed registries used to build components from config dicts.

Mirrors the public behavior of the reference toolbox's mmcv registries
(reference: mmdet/models/builder.py:7-15) without any mmcv dependency: a
config dict with a ``type`` key is resolved to a registered class and
instantiated with the remaining keys as kwargs.
"""
from __future__ import annotations

import copy
import inspect
from typing import Any, Callable, Dict, Optional

from .utils.profiling import span


class Registry:
    """A name -> class mapping with a decorator-based registration API."""

    def __init__(self, name: str):
        self._name = name
        self._module_dict: Dict[str, Any] = {}

    @property
    def name(self) -> str:
        return self._name

    @property
    def module_dict(self) -> Dict[str, Any]:
        return self._module_dict

    def __contains__(self, key: str) -> bool:
        return key in self._module_dict

    def __repr__(self) -> str:
        return f'Registry(name={self._name}, items={list(self._module_dict)})'

    def get(self, key: str) -> Optional[Any]:
        return self._module_dict.get(key)

    def register_module(self, name: Optional[str] = None, force: bool = False,
                        module: Optional[Any] = None) -> Callable:
        """Register a class or function, usable as decorator or direct call."""
        if module is not None:
            self._register(module, name=name, force=force)
            return module

        def _decorator(cls):
            self._register(cls, name=name, force=force)
            return cls

        return _decorator

    def _register(self, module, name=None, force=False):
        if name is None:
            name = module.__name__
        names = [name] if isinstance(name, str) else list(name)
        for n in names:
            if not force and n in self._module_dict:
                raise KeyError(f'{n} is already registered in {self._name}')
            self._module_dict[n] = module

    def build(self, cfg: Dict, **default_kwargs) -> Any:
        """Instantiate from ``cfg`` (must contain ``type``)."""
        if cfg is None:
            return None
        from collections.abc import Mapping
        if not isinstance(cfg, Mapping):
            raise TypeError(f'cfg must be a mapping, got {type(cfg)}')
        def _plain(v):
            if isinstance(v, Mapping):
                return {k: _plain(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return type(v)(_plain(x) for x in v)
            return v
        cfg = _plain(cfg)
        obj_type = cfg.pop('type')
        if isinstance(obj_type, str):
            obj_cls = self.get(obj_type)
            if obj_cls is None:
                raise KeyError(
                    f'{obj_type} is not registered in the {self._name} '
                    f'registry; available: {sorted(self._module_dict)}')
        elif inspect.isclass(obj_type) or inspect.isfunction(obj_type):
            obj_cls = obj_type
        else:
            raise TypeError(f'type must be a str or class, got {obj_type}')
        for k, v in default_kwargs.items():
            cfg.setdefault(k, v)
        return obj_cls(**cfg)


# Global registries (mirroring the reference's MODELS/DATASETS/PIPELINES).
BACKBONES = Registry('backbones')
NECKS = Registry('necks')
HEADS = Registry('heads')
LOSSES = Registry('losses')
DETECTORS = Registry('detectors')
DATASETS = Registry('datasets')
PIPELINES = Registry('pipelines')
PLUGINS = Registry('plugins')
PRIOR_GENERATORS = Registry('prior_generators')


def build_backbone(cfg):
    return BACKBONES.build(cfg)


def build_neck(cfg):
    return NECKS.build(cfg)


def build_head(cfg):
    return HEADS.build(cfg)


def build_loss(cfg):
    return LOSSES.build(cfg)


def build_detector(cfg, train_cfg=None, test_cfg=None):
    """Build a detector; train/test cfg may come from the top-level config
    (reference surface: mmdet/models/builder.py:42-59)."""
    with span('build_detector'):
        cfg = copy.deepcopy(dict(cfg))
        if train_cfg is not None:
            cfg.setdefault('train_cfg', train_cfg)
        if test_cfg is not None:
            cfg.setdefault('test_cfg', test_cfg)
        return DETECTORS.build(cfg)


def build_dataset(cfg, default_args=None):
    return DATASETS.build(cfg, **(default_args or {}))
