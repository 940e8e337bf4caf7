"""The serializable compression artifact (paper Eq. 7/8 + Fig. 3), in
numpy only.

A :class:`CompressionPlan` holds per-group channel bit-widths (0 ==
pruned), per-tensor activation precisions, PACT clip values, the Fig. 3
channel-reorder permutations and provenance metadata.  The file format is
the JAX package's (``repro.api.plan``): ``<stem>.json`` with
``format_version`` 1 for the scalars, ``<stem>.npz`` with ``bits::<grp>``
and ``perm::<grp>`` for the arrays, so a plan either package saves loads
field for field in the other.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional

import numpy as np

from repro_torch.core import discretize

FORMAT_VERSION = 1


def _stem(path: str) -> str:
    for suffix in (".npz", ".json"):
        if path.endswith(suffix):
            return path[: -len(suffix)]
    return path


@dataclasses.dataclass
class CompressionPlan:
    """Concrete per-channel precision assignment plus deployment layout."""

    pw: tuple[int, ...]                  # weight precision search space
    px: tuple[int, ...]                  # activation precision search space
    channel_bits: dict[str, np.ndarray]  # group -> (C,) int bits, 0 = pruned
    act_bits: dict[str, int]             # weight-node name -> act precision
    alphas: dict[str, float]             # weight-node name -> PACT clip
    permutations: dict[str, np.ndarray]  # group -> Fig. 3 reorder (C,) int
    meta: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def from_assignment(cls, assignment: dict, pw, px,
                        meta: Optional[dict] = None) -> "CompressionPlan":
        """Wrap a raw ``{"gamma","delta","alpha"}`` assignment dict."""
        bits = {k: np.asarray(v, np.int64)
                for k, v in assignment["gamma"].items()}
        perms = discretize.reorder_permutations({"gamma": bits})
        return cls(
            pw=tuple(int(p) for p in pw),
            px=tuple(int(p) for p in px),
            channel_bits=bits,
            act_bits={k: int(v) for k, v in assignment["delta"].items()},
            alphas={k: float(v) for k, v in assignment["alpha"].items()},
            permutations={k: np.asarray(v, np.int64)
                          for k, v in perms.items()},
            meta=dict(meta or {}),
        )

    def to_assignment(self, as_tensor: bool = False, device=None) -> dict:
        """Assignment dict for ``cnn.apply`` / ``core.discretize``; with
        ``as_tensor`` the bits and clip values are tensors on
        ``device``."""
        if as_tensor:
            import torch
            gamma = {k: torch.as_tensor(v, device=device)
                     for k, v in self.channel_bits.items()}
            alpha = {k: torch.tensor(v, dtype=torch.float32, device=device)
                     for k, v in self.alphas.items()}
        else:
            gamma = {k: np.asarray(v) for k, v in self.channel_bits.items()}
            alpha = dict(self.alphas)
        return {"gamma": gamma, "delta": dict(self.act_bits), "alpha": alpha}

    def size_bytes(self, geoms) -> float:
        return discretize.assignment_size_bytes(geoms, self.to_assignment())

    def prune_fraction(self) -> float:
        return discretize.prune_fraction(self.to_assignment())

    def bits_histogram(self) -> dict:
        return discretize.bits_histogram(self.to_assignment(), self.pw)

    def sublayer_split(self) -> dict:
        """Per-precision contiguous sub-layers after the Fig. 3 reorder,
        derived from the plan's STORED permutations:
        ``{group: [(bits, start, stop), ...]}``."""
        split = {}
        for grp, bits in self.channel_bits.items():
            sorted_bits = np.asarray(bits)[self.permutations[grp]]
            segs, start = [], 0
            for b in sorted(set(int(x) for x in sorted_bits if x > 0)):
                n = int(np.sum(sorted_bits == b))
                segs.append((b, start, start + n))
                start += n
            split[grp] = segs
        return split

    @property
    def groups(self) -> tuple[str, ...]:
        return tuple(sorted(self.channel_bits))

    def bind(self, weights: dict) -> dict:
        """Pack ``weights`` (group name -> (C_out, C_in) float matrix) for
        serving with this plan's channel bits and stored Fig. 3
        permutations; see ``serve.engine.export_plan_layers``."""
        from repro_torch.serve import engine
        return engine.export_plan_layers(self, weights)

    def scalars(self) -> dict:
        """The JSON-able (non-array) half of the plan."""
        return {
            "format_version": FORMAT_VERSION,
            "pw": list(self.pw),
            "px": list(self.px),
            "act_bits": {k: int(v) for k, v in self.act_bits.items()},
            "alphas": {k: float(v) for k, v in self.alphas.items()},
            "groups": sorted(self.channel_bits),
            "meta": self.meta,
        }

    def save(self, path: str) -> str:
        """Write ``<stem>.npz`` (arrays) + ``<stem>.json`` (scalars);
        returns the ``.npz`` path."""
        stem = _stem(path)
        arrays = {}
        for grp, bits in self.channel_bits.items():
            arrays[f"bits::{grp}"] = np.asarray(bits, np.int64)
            arrays[f"perm::{grp}"] = np.asarray(self.permutations[grp],
                                                np.int64)
        npz_path, json_path = stem + ".npz", stem + ".json"
        with open(npz_path, "wb") as f:
            np.savez(f, **arrays)
        with open(json_path, "w") as f:
            json.dump(self.scalars(), f, indent=2, sort_keys=True)
        return npz_path

    @classmethod
    def load(cls, path: str) -> "CompressionPlan":
        stem = _stem(path)
        with open(stem + ".json") as f:
            sc = json.load(f)
        if sc.get("format_version") != FORMAT_VERSION:
            raise ValueError(f"unsupported plan format version "
                             f"{sc.get('format_version')!r} in {stem}.json")
        bits, perms = {}, {}
        with np.load(stem + ".npz", allow_pickle=False) as z:
            for grp in sc["groups"]:
                bits[grp] = np.asarray(z[f"bits::{grp}"], np.int64)
                perms[grp] = np.asarray(z[f"perm::{grp}"], np.int64)
        return cls(pw=tuple(sc["pw"]), px=tuple(sc["px"]),
                   channel_bits=bits, act_bits=dict(sc["act_bits"]),
                   alphas=dict(sc["alphas"]), permutations=perms,
                   meta=dict(sc.get("meta", {})))

    def to_tree(self) -> dict:
        """Array-only tree (checkpointing); pairs with :meth:`scalars`."""
        return {"bits": {k: np.asarray(v, np.int64)
                         for k, v in self.channel_bits.items()},
                "perm": {k: np.asarray(v, np.int64)
                         for k, v in self.permutations.items()}}

    @classmethod
    def from_tree(cls, tree: dict, scalars: dict) -> "CompressionPlan":
        return cls(pw=tuple(scalars["pw"]), px=tuple(scalars["px"]),
                   channel_bits={k: np.asarray(v, np.int64)
                                 for k, v in tree["bits"].items()},
                   act_bits=dict(scalars["act_bits"]),
                   alphas=dict(scalars["alphas"]),
                   permutations={k: np.asarray(v, np.int64)
                                 for k, v in tree["perm"].items()},
                   meta=dict(scalars.get("meta", {})))

    def equals(self, other: "CompressionPlan") -> bool:
        """Exact equality of everything that affects deployment."""
        if not isinstance(other, CompressionPlan):
            return False
        if (self.pw != other.pw or self.px != other.px
                or set(self.channel_bits) != set(other.channel_bits)
                or self.act_bits != other.act_bits
                or set(self.alphas) != set(other.alphas)):
            return False
        if any(float(v) != float(other.alphas[k])
               for k, v in self.alphas.items()):
            return False
        return all(
            np.array_equal(bits, other.channel_bits[grp])
            and np.array_equal(self.permutations[grp],
                               other.permutations[grp])
            for grp, bits in self.channel_bits.items())

    def summary(self) -> str:
        n = sum(int(np.asarray(b).size) for b in self.channel_bits.values())
        pruned = self.prune_fraction()
        return (f"CompressionPlan({len(self.channel_bits)} groups, "
                f"{n} channels, {100 * pruned:.1f}% pruned, "
                f"pw={self.pw}, px={self.px})")
