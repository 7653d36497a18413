"""State carried across from the JAX package, as numpy values.

The system has no weights. Its state is the previous frame's features and the
configuration dataclasses. These helpers turn values of the JAX package's
containers (given as numpy arrays, over the same field names) into this
package's containers and back, and rebuild config dataclasses from
`dataclasses.asdict` dictionaries.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

from . import config as _config
from .models.matcher import FrameFeatures
from .ops.matching import Matches
from .ops.nms import FeatureSet


def _field(tree, name):
    return tree[name] if isinstance(tree, Mapping) else getattr(tree, name)


def _tensor(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x)).to(device)   # a writable copy


def feature_set_from_numpy(tree, device="cpu") -> FeatureSet:
    return FeatureSet(*(_tensor(_field(tree, f), device)
                        for f in FeatureSet._fields))


def matches_from_numpy(tree, device="cpu") -> Matches:
    return Matches(*(_tensor(_field(tree, f), device)
                     for f in Matches._fields))


def frame_features_from_numpy(tree, device="cpu") -> FrameFeatures:
    return FrameFeatures(
        sparse=feature_set_from_numpy(_field(tree, "sparse"), device),
        dense=feature_set_from_numpy(_field(tree, "dense"), device),
        du_full=_tensor(_field(tree, "du_full"), device),
        dv_full=_tensor(_field(tree, "dv_full"), device),
        img=_tensor(_field(tree, "img"), device),
    )


def to_numpy(tree):
    """A container of this package (NamedTuples nested at will) with every
    tensor as a numpy array; None stays None."""
    if tree is None:
        return None
    if torch.is_tensor(tree):
        return tree.detach().cpu().numpy()
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_numpy(x) for x in tree))
    raise TypeError(f"to_numpy: unsupported value of type {type(tree)}")


_CONFIG_CLASSES = {
    name: cls for name, cls in vars(_config).items()
    if dataclasses.is_dataclass(cls) and isinstance(cls, type)
}


def config_from_dict(d: Mapping, cls=None):
    """Rebuild a config dataclass from `dataclasses.asdict(cfg)` of either
    package. `cls` (a class of `config`, or its name) may be left out when
    the field names identify it."""
    if isinstance(cls, str):
        cls = _CONFIG_CLASSES[cls]
    if cls is None:
        hits = [c for c in _CONFIG_CLASSES.values()
                if {f.name for f in dataclasses.fields(c)} == set(d)]
        if len(hits) != 1:
            raise ValueError("config_from_dict: fields match "
                             f"{[c.__name__ for c in hits]}; pass cls")
        cls = hits[0]
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        sub = _CONFIG_CLASSES.get(str(f.type))
        kw[f.name] = config_from_dict(v, sub) if sub and isinstance(
            v, Mapping) else v
    unknown = set(d) - set(kw)
    if unknown:
        raise ValueError(f"{cls.__name__}: unknown fields {sorted(unknown)}")
    return cls(**kw)
