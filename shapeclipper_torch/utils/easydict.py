"""Attribute-style nested dict used as the universal config container.

Mirrors the semantics of the reference's EasyDict (reference
`utils/util.py:281-315`): attribute and item access are interchangeable,
nested dicts are converted recursively, and lists of dicts are converted
element-wise.
"""

from __future__ import annotations


class EasyDict(dict):
    """dict subclass with attribute access and recursive conversion."""

    def __init__(self, d=None, **kwargs):
        if d is None:
            d = {}
        else:
            d = dict(d)
        if kwargs:
            d.update(**kwargs)
        for k, v in d.items():
            setattr(self, k, v)

    def __setattr__(self, name, value):
        if isinstance(value, (list, tuple)):
            value = [self.__class__(x) if isinstance(x, dict) else x for x in value]
        elif isinstance(value, dict) and not isinstance(value, self.__class__):
            value = self.__class__(value)
        super().__setattr__(name, value)
        super().__setitem__(name, value)

    __setitem__ = __setattr__

    def __getattr__(self, name):
        # only called when normal attribute lookup fails
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def update(self, e=None, **f):
        d = dict(e or {})
        d.update(f)
        for k in d:
            setattr(self, k, d[k])

    def pop(self, k, d=None):
        if hasattr(self, k):
            object.__delattr__(self, k)
        return super().pop(k, d)

    def deepcopy(self):
        out = EasyDict()
        for k, v in self.items():
            if isinstance(v, EasyDict):
                out[k] = v.deepcopy()
            elif isinstance(v, list):
                out[k] = [x.deepcopy() if isinstance(x, EasyDict) else x for x in v]
            else:
                out[k] = v
        return out


def to_plain_dict(d):
    """Recursively convert EasyDict (and nested) back to plain dicts for YAML dump."""
    if isinstance(d, dict):
        return {k: to_plain_dict(v) for k, v in d.items()}
    if isinstance(d, (list, tuple)):
        return [to_plain_dict(x) for x in d]
    return d
