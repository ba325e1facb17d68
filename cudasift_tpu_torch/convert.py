"""State carried between the JAX package and the port: parameters and
``SiftData``. Plain numpy in and out; nothing here imports jax."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import HomographyParams, MatchParams, SiftParams
from .sift_data import SiftData

_INT_FIELDS = ("num_pts", "match", "overflow")


def params_from_jax(p):
    """The port's parameter object with the same field values as ``p``.

    ``p`` is any object carrying every field of ``SiftParams``,
    ``HomographyParams`` or ``MatchParams`` (checked in that order).
    """
    for cls in (SiftParams, HomographyParams, MatchParams):
        names = [f.name for f in dataclasses.fields(cls)]
        if all(hasattr(p, n) for n in names):
            return cls(**{n: getattr(p, n) for n in names})
    raise TypeError(f"{type(p).__name__} matches no parameter class of the port")


def sift_data_from_numpy(arrays: dict, device: torch.device | str = "cpu") -> SiftData:
    """``SiftData`` from a dict of array-likes keyed by field name."""
    out = {}
    for f in dataclasses.fields(SiftData):
        dtype = torch.int32 if f.name in _INT_FIELDS else torch.float32
        out[f.name] = torch.tensor(np.asarray(arrays[f.name]), dtype=dtype,
                                   device=device)
    return SiftData(**out)


def sift_data_to_numpy(data: SiftData) -> dict:
    """Dict of host numpy arrays keyed by ``SiftData`` field name."""
    return {f.name: getattr(data, f.name).cpu().numpy()
            for f in dataclasses.fields(data)}
