"""Content-addressed on-disk store of compression plans + eval metadata
(``repro.sweep.store``).  The on-disk layout, the entry JSON bytes and
:func:`plan_hash` are the JAX package's, so each package reads and
verifies the other's store.

A :class:`PlanStore` is the durable half of a Pareto sweep: every finished
search point lands here as (a) the
:class:`~repro_torch.api.plan.CompressionPlan` itself, written once under
its content hash, and (b) a small named *entry*
JSON carrying the point's evaluation metrics, its discrete cost per
registered cost model, and its sweep lineage (which spec, which lambda,
warm-started from which parent).  Layout::

    <root>/plans/<hash>.npz     # CompressionPlan arrays (written once)
    <root>/plans/<hash>.json    # CompressionPlan scalars + provenance
    <root>/entries/<name>.json  # metrics + costs + lineage -> plan hash

Plans are deduplicated by :func:`plan_hash` -- a blake2b digest over
everything that affects deployment (pw/px, per-group channel bits +
permutations, act bits, alphas) and nothing that doesn't (``meta`` is
excluded, so two lambdas that converge to the same assignment share one
plan file).  Entry JSONs are written atomically (tmp + rename) with sorted
keys and no timestamps, so a killed-and-resumed sweep that reproduces the
same points produces byte-identical entries.

Every read path raises :class:`StoreError` with a message naming the file
and the failure mode (missing ``.npz`` beside its ``.json``, truncated
arrays, content-hash mismatch) instead of leaking ``KeyError`` /
``zipfile.BadZipFile`` internals.
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile

import numpy as np

from repro_torch.api.plan import CompressionPlan

ENTRY_VERSION = 1


class StoreError(RuntimeError):
    """A PlanStore read/write failed in a way the caller should see."""


class StoreCorruptError(StoreError):
    """A stored file exists but cannot be trusted: unparsable entry
    JSON, missing/truncated plan arrays, or a content-hash mismatch.
    Distinct from plain :class:`StoreError` (missing entries, invalid
    names, spec mismatches) so resume paths can quarantine-and-recompute
    corruption without masking real usage errors."""


def plan_hash(plan: CompressionPlan) -> str:
    """Content hash of everything that affects a plan's deployment.

    Matches :meth:`CompressionPlan.equals`: pw/px, per-group channel bits
    and Fig. 3 permutations, activation bits and PACT alphas.  ``meta``
    (provenance) is deliberately excluded so identical assignments found
    by different sweep points share one stored plan.
    """
    h = hashlib.blake2b(digest_size=16)
    h.update(f"pw={tuple(plan.pw)};px={tuple(plan.px)}".encode())
    for grp in sorted(plan.channel_bits):
        h.update(grp.encode())
        h.update(np.asarray(plan.channel_bits[grp], np.int64).tobytes())
        h.update(np.asarray(plan.permutations[grp], np.int64).tobytes())
    for name in sorted(plan.act_bits):
        h.update(f"{name}={int(plan.act_bits[name])}".encode())
    for name in sorted(plan.alphas):
        h.update(f"{name}={float(plan.alphas[name])!r}".encode())
    return h.hexdigest()


def _atomic_write_text(path: str, text: str):
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


class PlanStore:
    """List/query/load API over the on-disk layout above."""

    def __init__(self, root: str):
        self.root = root
        self.plans_dir = os.path.join(root, "plans")
        self.entries_dir = os.path.join(root, "entries")

    # ----------------------------------------------------------- writing
    def put(self, plan: CompressionPlan, name: str, *, metrics=None,
            costs=None, lineage=None) -> dict:
        """Store ``plan`` under its content hash and write/overwrite the
        named entry pointing at it.  Returns the entry dict."""
        if "/" in name or not name:
            raise StoreError(f"invalid entry name {name!r}")
        os.makedirs(self.plans_dir, exist_ok=True)
        os.makedirs(self.entries_dir, exist_ok=True)
        h = plan_hash(plan)
        stem = os.path.join(self.plans_dir, h)
        # content-addressed: an already-stored plan is never rewritten
        if not (os.path.exists(stem + ".npz")
                and os.path.exists(stem + ".json")):
            plan.save(stem)
        entry = {
            "entry_version": ENTRY_VERSION,
            "name": name,
            "plan": h,
            "metrics": dict(metrics or {}),
            "costs": dict(costs or {}),
            "lineage": dict(lineage or {}),
        }
        _atomic_write_text(self._entry_path(name),
                           json.dumps(entry, indent=2, sort_keys=True)
                           + "\n")
        return entry

    # ----------------------------------------------------------- reading
    def _entry_path(self, name: str) -> str:
        return os.path.join(self.entries_dir, f"{name}.json")

    def names(self) -> list[str]:
        if not os.path.isdir(self.entries_dir):
            return []
        return sorted(f[:-5] for f in os.listdir(self.entries_dir)
                      if f.endswith(".json")
                      and not f.endswith(".quarantined.json"))

    def has(self, name: str) -> bool:
        return os.path.exists(self._entry_path(name))

    def entry(self, name: str) -> dict:
        path = self._entry_path(name)
        if not os.path.exists(path):
            raise StoreError(f"no entry {name!r} in store {self.root}")
        try:
            with open(path) as f:
                entry = json.load(f)
        except (json.JSONDecodeError, OSError) as e:
            raise StoreCorruptError(
                f"entry {name!r} is corrupt ({path}): {e}") from e
        if not isinstance(entry, dict):
            raise StoreCorruptError(
                f"entry {name!r} is corrupt ({path}): not a JSON object")
        for key in ("name", "plan", "metrics", "costs", "lineage"):
            if key not in entry:
                raise StoreCorruptError(
                    f"entry {name!r} is corrupt ({path}): "
                    f"missing field {key!r}")
        return entry

    def entries(self) -> list[dict]:
        return [self.entry(n) for n in self.names()]

    def get(self, h: str) -> CompressionPlan:
        """Load a plan by content hash, verifying integrity."""
        stem = os.path.join(self.plans_dir, h)
        if not os.path.exists(stem + ".json"):
            raise StoreError(f"no plan {h} in store {self.root}")
        if not os.path.exists(stem + ".npz"):
            raise StoreCorruptError(
                f"plan {h} is missing its .npz array file beside "
                f"{stem}.json (partial copy or interrupted write?)")
        try:
            plan = CompressionPlan.load(stem)
        except Exception as e:
            raise StoreCorruptError(
                f"plan {h} is corrupt or truncated ({stem}.npz): "
                f"{e}") from e
        actual = plan_hash(plan)
        if actual != h:
            raise StoreCorruptError(
                f"plan {h} failed its content-hash check (stored arrays "
                f"hash to {actual}): store was modified or truncated")
        return plan

    def load(self, name: str) -> CompressionPlan:
        """Load the plan a named entry points at."""
        return self.get(self.entry(name)["plan"])

    # ----------------------------------------------------------- queries
    def query(self, **filters) -> list[dict]:
        """Entries whose top-level or ``lineage`` fields equal every
        filter value, e.g. ``query(sweep="pareto", warm=True)``."""
        out = []
        for entry in self.entries():
            ok = True
            for key, want in filters.items():
                have = entry.get(key, entry["lineage"].get(key))
                if have != want:
                    ok = False
                    break
            if ok:
                out.append(entry)
        return out

    def front(self, entries=None, *, score_key: str = "score",
              cost_key: str = "size") -> list[dict]:
        """Pareto front (max score, min cost) over ``entries`` (default:
        all entries carrying both keys), sorted by cost."""
        from repro_torch.sweep import front as front_mod
        if entries is None:
            entries = self.entries()
        pts = [e for e in entries
               if score_key in e["metrics"] and cost_key in e["costs"]]
        return front_mod.pareto_front(
            pts, score=lambda e: e["metrics"][score_key],
            cost=lambda e: e["costs"][cost_key])

    def quarantine(self, name: str) -> str:
        """Move a named entry aside as ``<name>.quarantined.json`` (an
        existing quarantine file for the name is overwritten).  The name
        disappears from :meth:`names`/:meth:`has`, so a resuming sweep
        recomputes the point; the bad bytes stay on disk for forensics.
        Returns the quarantine path."""
        path = self._entry_path(name)
        if not os.path.exists(path):
            raise StoreError(f"no entry {name!r} in store {self.root}")
        qpath = os.path.join(self.entries_dir,
                             f"{name}.quarantined.json")
        os.replace(path, qpath)
        return qpath

    def verify(self, repair: bool = False) -> list[str]:
        """Integrity sweep: every entry parses and its plan loads with a
        matching content hash.  Returns problem strings (empty = clean).
        ``repair=True`` additionally quarantines each corrupt entry
        (:meth:`quarantine`) so subsequent reads see a clean store."""
        problems = []
        for name in self.names():
            try:
                self.load(name)
            except StoreCorruptError as e:
                msg = str(e)
                if repair:
                    msg += f" [quarantined -> {self.quarantine(name)}]"
                problems.append(msg)
            except StoreError as e:
                problems.append(str(e))
        return problems
