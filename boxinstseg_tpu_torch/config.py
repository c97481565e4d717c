"""Python-file configuration system.

Re-implements (from observed semantics, not code) the config surface the
reference toolbox exposes via mmcv.Config so its shipped configs run
unchanged (reference: tools/train.py:74-83 and configs/*):

- configs are plain ``.py`` files executed in an isolated namespace;
- a ``_base_`` key (str or list) pulls in parent configs, merged depth-first;
- a dict containing ``_delete_: True`` replaces the base dict instead of
  merging into it;
- dotted CLI overrides (``--cfg-options a.b.c=v``) mutate the final tree.
"""
from __future__ import annotations

import ast
import copy
import os
import types
from typing import Any, Dict, List, Optional, Union

DELETE_KEY = '_delete_'
BASE_KEY = '_base_'
RESERVED_KEYS = ('filename',)


class ConfigDict(dict):
    """A dict whose items are also attributes, recursively."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name, value):
        self[name] = value

    def __delattr__(self, name):
        try:
            del self[name]
        except KeyError:
            raise AttributeError(name)

    @staticmethod
    def _wrap(value):
        if isinstance(value, dict) and not isinstance(value, ConfigDict):
            return ConfigDict({k: ConfigDict._wrap(v) for k, v in value.items()})
        if isinstance(value, (list, tuple)):
            return type(value)(ConfigDict._wrap(v) for v in value)
        return value

    def __deepcopy__(self, memo):
        out = ConfigDict()
        memo[id(self)] = out
        for k, v in self.items():
            out[copy.deepcopy(k, memo)] = copy.deepcopy(v, memo)
        return out

    def get(self, key, default=None):
        return super().get(key, default)

    def copy(self):
        return copy.deepcopy(self)


def _exec_pyfile(filename: str) -> Dict[str, Any]:
    with open(filename, 'r') as f:
        source = f.read()
    # Validate it parses before exec for a clearer error message.
    ast.parse(source, filename=filename)
    module = types.ModuleType('_cfg_')
    module.__file__ = filename
    namespace: Dict[str, Any] = module.__dict__
    namespace['__file__'] = filename
    code = compile(source, filename, 'exec')
    exec(code, namespace)
    return {
        k: v for k, v in namespace.items()
        if not k.startswith('__') and not isinstance(v, types.ModuleType)
        and not callable(v)
    }


def _merge_into(base: Dict, new: Dict) -> Dict:
    """Merge ``new`` over ``base`` with mmcv ``_delete_`` semantics."""
    base = copy.deepcopy(base)
    for key, value in new.items():
        if isinstance(value, dict) and key in base:
            if value.pop(DELETE_KEY, False):
                base[key] = copy.deepcopy(value)
            elif isinstance(base[key], dict):
                base[key] = _merge_into(base[key], value)
            else:
                base[key] = copy.deepcopy(value)
        else:
            if isinstance(value, dict):
                value = dict(value)
                value.pop(DELETE_KEY, None)
            base[key] = copy.deepcopy(value)
    return base


def _load_cfg_dict(filename: str) -> Dict[str, Any]:
    filename = os.path.abspath(os.path.expanduser(filename))
    if not filename.endswith('.py'):
        raise ValueError(f'only python configs are supported, got {filename}')
    cfg_dict = _exec_pyfile(filename)

    base_files = cfg_dict.pop(BASE_KEY, None)
    if base_files is None:
        return cfg_dict
    if isinstance(base_files, str):
        base_files = [base_files]
    cfg_dir = os.path.dirname(filename)
    merged: Dict[str, Any] = {}
    for base in base_files:
        base_dict = _load_cfg_dict(os.path.join(cfg_dir, base))
        dup = set(merged) & set(base_dict)
        if dup:
            raise KeyError(f'duplicate keys across _base_ configs: {dup}')
        merged.update(base_dict)
    return _merge_into(merged, cfg_dict)


def _set_dotted(cfg: Dict, dotted_key: str, value: Any) -> None:
    parts = dotted_key.split('.')
    d = cfg
    for p in parts[:-1]:
        if isinstance(d, (list, tuple)):
            d = d[int(p)]
        else:
            if p not in d or not isinstance(d[p], (dict, list, tuple)):
                d[p] = ConfigDict()
            d = d[p]
    last = parts[-1]
    if isinstance(d, (list, tuple)):
        d[int(last)] = value
    else:
        d[last] = value


def _parse_option_value(value: str) -> Any:
    """Best-effort literal parsing for CLI override strings."""
    if not isinstance(value, str):
        return value
    try:
        return ast.literal_eval(value)
    except (SyntaxError, ValueError):
        pass
    lowered = value.lower()
    if lowered in ('true', 'false'):
        return lowered == 'true'
    if lowered in ('none', 'null'):
        return None
    if ',' in value:
        return [_parse_option_value(v) for v in value.split(',')]
    return value


_PATTERN_KEY = None


def replace_cfg_vals(cfg: 'Config') -> 'Config':
    """Replace every "${key}" / "xxx${a.b}xxx" string with the value of
    cfg.key (reference: mmdet/utils/replace_cfg_vals.py, applied in
    tools/train.py:114). Also honors the ``model_wrapper`` swap."""
    import re
    global _PATTERN_KEY
    if _PATTERN_KEY is None:
        _PATTERN_KEY = re.compile(r'\$\{[a-zA-Z\d_.]*\}')

    root = cfg._cfg_dict

    def get_value(key):
        d = root
        for k in key.split('.'):
            d = d[k]
        return d

    def replace_value(v):
        if isinstance(v, dict):
            return ConfigDict({k: replace_value(x) for k, x in v.items()})
        if isinstance(v, (list, tuple)):
            return type(v)(replace_value(x) for x in v)
        if isinstance(v, str):
            keys = _PATTERN_KEY.findall(v)
            if not keys:
                return v
            values = [get_value(k[2:-1]) for k in keys]
            if len(keys) == 1 and keys[0] == v:
                return values[0]
            for k, val in zip(keys, values):
                assert not isinstance(val, (dict, list, tuple)), \
                    f'cannot splice {type(val)} into string {v!r}'
                v = v.replace(k, str(val))
            return v
        return v

    out = Config(replace_value(root), filename=cfg.filename)
    if out.get('model_wrapper') is not None:
        out.model = out['model_wrapper']
        del out._cfg_dict['model_wrapper']
    return out


def compat_cfg(cfg: 'Config') -> 'Config':
    """Legacy-config migrations (reference: mmdet/utils/compat_config.py):
    ``total_epochs`` -> ``runner``, ``imgs_per_gpu`` -> ``samples_per_gpu``,
    per-split ``samples_per_gpu``/``workers_per_gpu`` hoisted from
    data.train (the fields this fork's old configs used)."""
    import warnings
    cfg = cfg.copy()
    data = cfg.get('data')
    if data is not None:
        if 'imgs_per_gpu' in data:
            warnings.warn('"imgs_per_gpu" is deprecated; using it as '
                          '"samples_per_gpu"', UserWarning)
            data['samples_per_gpu'] = data.pop('imgs_per_gpu')
        train = data.get('train')
        if isinstance(train, dict):
            for key in ('samples_per_gpu', 'workers_per_gpu'):
                if key in train and key not in data:
                    data[key] = train.pop(key)
                else:
                    train.pop(key, None)
    if 'runner' not in cfg:
        if 'total_epochs' in cfg:
            warnings.warn('config should define a `runner` section; '
                          'migrating total_epochs', UserWarning)
            cfg.runner = dict(type='EpochBasedRunner',
                              max_epochs=cfg['total_epochs'])
    elif 'total_epochs' in cfg:
        assert cfg['total_epochs'] == cfg.runner['max_epochs']
    return cfg


class Config:
    """Loaded configuration tree with attribute access."""

    def __init__(self, cfg_dict: Optional[Dict] = None,
                 filename: Optional[str] = None):
        cfg_dict = cfg_dict or {}
        object.__setattr__(self, '_cfg_dict', ConfigDict._wrap(cfg_dict))
        object.__setattr__(self, '_filename', filename)

    @staticmethod
    def fromfile(filename: Union[str, os.PathLike]) -> 'Config':
        cfg_dict = _load_cfg_dict(str(filename))
        return Config(cfg_dict, filename=str(filename))

    @staticmethod
    def fromdict(cfg_dict: Dict) -> 'Config':
        return Config(copy.deepcopy(cfg_dict))

    # ---- mapping / attribute protocol -------------------------------------
    @property
    def filename(self):
        return self._filename

    def __getattr__(self, name):
        return getattr(self._cfg_dict, name)

    def __setattr__(self, name, value):
        self._cfg_dict[name] = ConfigDict._wrap(value)

    def __getitem__(self, name):
        return self._cfg_dict[name]

    def __setitem__(self, name, value):
        self._cfg_dict[name] = ConfigDict._wrap(value)

    def __contains__(self, name):
        return name in self._cfg_dict

    def __iter__(self):
        return iter(self._cfg_dict)

    def get(self, name, default=None):
        return self._cfg_dict.get(name, default)

    def keys(self):
        return self._cfg_dict.keys()

    def items(self):
        return self._cfg_dict.items()

    def to_dict(self) -> Dict:
        def _plain(v):
            if isinstance(v, dict):
                return {k: _plain(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return type(v)(_plain(x) for x in v)
            return v
        return _plain(self._cfg_dict)

    def copy(self) -> 'Config':
        return Config(copy.deepcopy(self.to_dict()), filename=self._filename)

    def merge_from_dict(self, options: Dict[str, Any]) -> None:
        """Apply ``--cfg-options``-style dotted overrides."""
        for key, value in (options or {}).items():
            _set_dotted(self._cfg_dict, key, ConfigDict._wrap(
                _parse_option_value(value)))

    def dump(self, path: str) -> None:
        import pprint
        with open(path, 'w') as f:
            for k, v in self._cfg_dict.items():
                f.write(f'{k} = {pprint.pformat(v, width=100)}\n')

    def __repr__(self):
        import pprint
        return f'Config(file={self._filename}):\n' + pprint.pformat(
            self.to_dict(), width=100)
