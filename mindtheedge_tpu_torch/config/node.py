"""Minimal yacs-compatible config tree: counterpart of
``mindtheedge_tpu/config/node.py``, the same class.

* attribute-style access (``cfg.model.depth_net.name``)
* ``merge_from_file`` / ``merge_from_other_cfg`` deep merges
* string values that look like Python literals are coerced with
  ``ast.literal_eval`` (yacs ``_decode_cfg_value`` semantics) so YAML entries
  like ``image_shape: (384, 1280)`` become tuples
* tuple<->list coercion on merge (yacs ``_check_and_coerce_cfg_value_type``)

``yaml`` is imported only where a file is read or written.
"""

import ast
import copy


class ConfigNode(dict):
    """A dict with attribute access and yacs-style merging."""

    def __init__(self, init_dict=None):
        init_dict = {} if init_dict is None else init_dict
        super().__init__()
        for k, v in init_dict.items():
            self[k] = ConfigNode(v) if isinstance(v, dict) else v

    # -- attribute access -------------------------------------------------
    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name, value):
        self[name] = ConfigNode(value) if isinstance(value, dict) and not isinstance(value, ConfigNode) else value

    def __delattr__(self, name):
        del self[name]

    # -- cloning -----------------------------------------------------------
    def clone(self):
        return copy.deepcopy(self)

    # -- merging -----------------------------------------------------------
    @staticmethod
    def _decode(value):
        """Coerce str values that parse as Python literals (yacs behaviour)."""
        if not isinstance(value, str):
            return value
        try:
            decoded = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            return value
        # Only keep the decoded value for container/number literals; plain
        # strings like 'Adam' raise above and stay strings.
        return decoded

    @staticmethod
    def _coerce(replacement, original, full_key):
        if original is None or replacement is None:
            return replacement
        r_type, o_type = type(replacement), type(original)
        if r_type == o_type:
            return replacement
        # tuple <-> list casts
        if isinstance(replacement, (tuple, list)) and isinstance(original, (tuple, list)):
            return o_type(replacement)
        # numeric promotion
        if isinstance(replacement, (int, float)) and isinstance(original, (int, float)) \
                and not isinstance(replacement, bool) and not isinstance(original, bool):
            return replacement
        raise ValueError(
            f'Type mismatch ({o_type} vs {r_type}) for config key {full_key}')

    def merge_from_other_cfg(self, other, _prefix='', strict=False):
        """Deep-merge ``other`` into self.

        With ``strict=False`` (default) unknown keys are added rather than
        rejected; the reference relies on yaml keys that exist in defaults,
        but test-time ckpt-embedded configs may carry extras.
        """
        for k, v in other.items():
            full_key = f'{_prefix}{k}'
            if isinstance(v, dict):
                if k not in self or not isinstance(self[k], ConfigNode):
                    if strict and k not in self:
                        raise KeyError(f'Non-existent config key: {full_key}')
                    self[k] = ConfigNode()
                self[k].merge_from_other_cfg(v, _prefix=full_key + '.', strict=strict)
            else:
                v = self._decode(v)
                if k in self and not isinstance(self[k], ConfigNode):
                    v = self._coerce(v, self[k], full_key)
                elif strict and k not in self:
                    raise KeyError(f'Non-existent config key: {full_key}')
                self[k] = v
        return self

    def merge_from_file(self, path):
        import yaml
        with open(path, 'r') as f:
            data = yaml.safe_load(f) or {}
        return self.merge_from_other_cfg(data)

    def merge_from_list(self, opts):
        if len(opts) % 2:
            raise ValueError('Override list must have even length')
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split('.')
            for p in parts[:-1]:
                node = node[p]
            old = node.get(parts[-1])
            value = self._decode(value)
            if old is not None and not isinstance(old, ConfigNode):
                value = self._coerce(value, old, key)
            node[parts[-1]] = value
        return self

    # -- (de)serialisation ---------------------------------------------------
    def to_dict(self):
        out = {}
        for k, v in self.items():
            out[k] = v.to_dict() if isinstance(v, ConfigNode) else v
        return out

    def dump(self):
        import yaml
        return yaml.safe_dump(self.to_dict(), default_flow_style=False)

    # NOTE: method names on this class must never collide with config keys
    # (the reference tree has a ``save`` section, so this is ``save_yaml``).
    def save_yaml(self, path):
        with open(path, 'w') as f:
            f.write(self.dump())
