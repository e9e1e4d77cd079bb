"""Bit-for-bit comparison of two result trees, one from the port's scalar
engines and one from the reference's: every leaf equal with ``==`` and of
the same type, NaN where the other has NaN, dict keys equal and in the
same order, lists element for element."""
import dataclasses
import math

import numpy as np


def mismatches(got, want, path="result"):
    """Paths at which ``got`` and ``want`` differ; [] when equal."""
    if dataclasses.is_dataclass(want) and not isinstance(want, type):
        if type(got).__name__ != type(want).__name__:
            return [f"{path}: type {type(got).__name__} != "
                    f"{type(want).__name__}"]
        names = [f.name for f in dataclasses.fields(want)]
        if [f.name for f in dataclasses.fields(got)] != names:
            return [f"{path}: fields differ"]
        out = []
        for n in names:
            out += mismatches(getattr(got, n), getattr(want, n),
                              f"{path}.{n}")
        return out
    if isinstance(want, dict):
        if not isinstance(got, dict):
            return [f"{path}: {type(got).__name__} is not a dict"]
        if list(got) != list(want):
            return [f"{path}: keys {list(got)} != {list(want)}"]
        out = []
        for k in want:
            out += mismatches(got[k], want[k], f"{path}[{k!r}]")
        return out
    if isinstance(want, (list, tuple)):
        if type(got) is not type(want) or len(got) != len(want):
            return [f"{path}: {type(got).__name__} of {len(got)} != "
                    f"{type(want).__name__} of {len(want)}"]
        out = []
        for i, (g, w) in enumerate(zip(got, want)):
            out += mismatches(g, w, f"{path}[{i}]")
        return out
    if isinstance(want, np.ndarray):
        ok = (isinstance(got, np.ndarray) and got.dtype == want.dtype
              and got.shape == want.shape
              and np.array_equal(got, want,
                                 equal_nan=want.dtype.kind == "f"))
        return [] if ok else [f"{path}: arrays differ"]
    if type(got).__name__ != type(want).__name__:
        return [f"{path}: type {type(got).__name__} != "
                f"{type(want).__name__}"]
    if isinstance(want, float) and math.isnan(want):
        return [] if math.isnan(got) else [f"{path}: {got!r} != nan"]
    return [] if got == want else [f"{path}: {got!r} != {want!r}"]
