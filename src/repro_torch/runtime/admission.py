"""ΔG admission guard: validate every update batch before device state
(counterpart of ``repro.runtime.admission``; numpy throughout, torch
only where a sanitized batch goes back to its device).

The paper's runtime trusts its update stream; a serving runtime cannot.
Negative vertex ids index CSR offset arrays from the *end* (silent
corruption), ids ≥ n scatter into the pad region, NaN weights poison
every downstream float reduction, and an adversarial giant batch forces
unbounded diff-pool growth.  The guard runs one vectorized host pass
over the batch (or, for streams, one pass over the whole host-side
arrays — amortized to noise on the fused hot path) and applies a
per-session policy:

  * ``reject``     — raise :class:`AdmissionError` with machine-readable
                     reasons; session state untouched.
  * ``clamp``      — sanitize what is repairable (mask off out-of-range
                     lanes, repair NaN/Inf/negative weights to 1) and
                     admit the rest; unsanitizable batches (oversized)
                     are quarantined.  The default: valid batches pass
                     through *unchanged* (same object, bit-exact).
  * ``quarantine`` — divert the whole offending batch to the bounded
                     dead-letter buffer; the session skips it and keeps
                     serving.
  * ``off``        — no validation (the pre-PR-8 behavior; what the
                     guarded-vs-unguarded benchmark row compares against).

``add_del_conflict`` (the same edge added and deleted in one batch) is
*counted* but never blocks admission under ``clamp``: the engine's
delete-before-add batch order makes it deterministic (the edge ends
alive), and the paper's own delete-then-re-add streams rely on it.
Under ``reject``/``quarantine`` it is a violation like any other —
callers choosing the strict policies asked for unambiguous streams.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

import torch

from repro_torch.runtime.errors import AdmissionError

ADMISSION_POLICIES = ("reject", "clamp", "quarantine", "off")

DEFAULT_MAX_BATCH = 1 << 16

# violation kinds and whether ``clamp`` can sanitize them
_CLAMPABLE = {
    "add_id_out_of_range": True,
    "del_id_out_of_range": True,
    "weight_invalid": True,
    "add_del_conflict": True,    # no-op under clamp: ordering is defined
    "batch_oversized": False,
    # pool-level finding: a queued request dropped under the shed
    # policy (the serving pool); never clampable — the batch was not applied
    "pool_saturated": False,
}


@dataclasses.dataclass(frozen=True)
class Violation:
    """One machine-readable admission finding."""

    kind: str        # key of _CLAMPABLE
    count: int       # offending lanes (1 for batch-level findings)
    detail: str = ""

    @property
    def clampable(self) -> bool:
        return _CLAMPABLE[self.kind]

    def as_dict(self) -> dict:
        return {"kind": self.kind, "count": int(self.count),
                "detail": self.detail}


@dataclasses.dataclass(frozen=True)
class QuarantineRecord:
    """A dead-lettered batch: the reasons, where in the stream it sat,
    and the batch itself (kept for offline repair/replay)."""

    reasons: Tuple[Violation, ...]
    cursor: int                    # session cursor when quarantined
    index: Optional[int] = None    # batch index within a stream, if any
    n_adds: int = 0                # active (masked-in) lanes
    n_dels: int = 0
    batch: object = None

    def as_dict(self) -> dict:
        return {"reasons": [r.as_dict() for r in self.reasons],
                "cursor": self.cursor, "index": self.index,
                "n_adds": self.n_adds, "n_dels": self.n_dels}


class DeadLetterBuffer:
    """Bounded FIFO of :class:`QuarantineRecord`; oldest records are
    evicted (and counted) when full, so a poison flood cannot OOM the
    process through its own quarantine log."""

    def __init__(self, capacity: int = 64):
        self.capacity = max(int(capacity), 1)
        self._q: collections.deque = collections.deque(maxlen=self.capacity)
        self.total = 0       # records ever pushed
        self.evicted = 0     # records dropped to stay bounded

    def push(self, rec: QuarantineRecord) -> None:
        if len(self._q) == self.capacity:
            self.evicted += 1
        self._q.append(rec)
        self.total += 1

    def records(self) -> List[QuarantineRecord]:
        return list(self._q)

    def __len__(self) -> int:
        return len(self._q)

    def as_dict(self) -> dict:
        return {"capacity": self.capacity, "held": len(self._q),
                "total": self.total, "evicted": self.evicted,
                "records": [r.as_dict() for r in self._q]}


# ---------------------------------------------------------------------------
# Vectorized violation detection
# ---------------------------------------------------------------------------

def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def _bad_ids(src, dst, mask, n) -> np.ndarray:
    return mask & ((src < 0) | (src >= n) | (dst < 0) | (dst >= n))


def _bad_w(w, mask) -> np.ndarray:
    with np.errstate(invalid="ignore"):
        bad = ~np.isfinite(w.astype(np.float64, copy=False)) | (w < 0)
    return mask & bad


def _conflicts(a_src, a_dst, a_ok, d_src, d_dst, d_ok, n) -> int:
    """Count (src, dst) pairs both added and deleted in one batch
    (in-range active lanes only — out-of-range lanes are already their
    own violation)."""
    if not (a_ok.any() and d_ok.any()):
        return 0
    ak = a_src[a_ok].astype(np.int64) * n + a_dst[a_ok].astype(np.int64)
    dk = d_src[d_ok].astype(np.int64) * n + d_dst[d_ok].astype(np.int64)
    return int(np.isin(np.unique(ak), np.unique(dk)).sum())


def batch_violations(batch, n: int,
                     max_batch: int = DEFAULT_MAX_BATCH) -> List[Violation]:
    """One host pass over an :class:`UpdateBatch`; empty list = clean."""
    out: List[Violation] = []
    a_src, a_dst = _host(batch.add_src), _host(batch.add_dst)
    a_w, a_mask = _host(batch.add_w), _host(batch.add_mask)
    d_src, d_dst = _host(batch.del_src), _host(batch.del_dst)
    d_mask = _host(batch.del_mask)

    if batch.size > max_batch:
        out.append(Violation("batch_oversized", 1,
                             f"size {batch.size} > max_batch {max_batch}"))
    bad_a = _bad_ids(a_src, a_dst, a_mask, n)
    if bad_a.any():
        out.append(Violation("add_id_out_of_range", int(bad_a.sum()),
                             f"vertex ids outside [0, {n})"))
    bad_d = _bad_ids(d_src, d_dst, d_mask, n)
    if bad_d.any():
        out.append(Violation("del_id_out_of_range", int(bad_d.sum()),
                             f"vertex ids outside [0, {n})"))
    bad_w = _bad_w(a_w, a_mask & ~bad_a)
    if bad_w.any():
        out.append(Violation("weight_invalid", int(bad_w.sum()),
                             "NaN/Inf or negative add weight"))
    nc = _conflicts(a_src, a_dst, a_mask & ~bad_a,
                    d_src, d_dst, d_mask & ~bad_d, max(n, 1))
    if nc:
        out.append(Violation("add_del_conflict", nc,
                             "edge both added and deleted in one batch "
                             "(delete-before-add order applies)"))
    return out


def sanitize_batch(batch, n: int):
    """The ``clamp`` repair: mask off out-of-range lanes, repair invalid
    weights to 1, preserve everything valid bit-exactly.  Returns a new
    UpdateBatch (int32 lanes, the dtype every engine expects) on the
    batch's device."""
    from repro_torch.graph.updates import UpdateBatch

    a_src, a_dst = _host(batch.add_src), _host(batch.add_dst)
    a_w, a_mask = _host(batch.add_w), _host(batch.add_mask)
    d_src, d_dst = _host(batch.del_src), _host(batch.del_dst)
    d_mask = _host(batch.del_mask)

    a_ok = a_mask & ~_bad_ids(a_src, a_dst, a_mask, n)
    d_ok = d_mask & ~_bad_ids(d_src, d_dst, d_mask, n)
    w = a_w.astype(np.float64, copy=True)
    with np.errstate(invalid="ignore"):
        w[~np.isfinite(w) | (w < 0)] = 1.0
    # dead lanes are zeroed so a sanitized batch is shape-stable and
    # never carries the poison values anywhere, even masked
    z = lambda arr, ok: np.where(ok, arr, 0).astype(np.int32)
    dev = batch.add_src.device
    put = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    return UpdateBatch(
        add_src=put(z(a_src, a_ok)), add_dst=put(z(a_dst, a_ok)),
        add_w=put(np.where(a_ok, w, 0).astype(np.int32)),
        add_mask=put(a_ok),
        del_src=put(z(d_src, d_ok)), del_dst=put(z(d_dst, d_ok)),
        del_mask=put(d_ok),
    )


def stream_batch_violations(stream, batch_size: int, n: int,
                            max_batch: int = DEFAULT_MAX_BATCH
                            ) -> Dict[int, List[Violation]]:
    """Per-batch violation map for a whole :class:`UpdateStream`, from
    ONE vectorized pass over the raw host arrays (before the padded
    batch views are even built — ``UpdateStream.batch`` would silently
    int-cast NaN weights).  Keys are batch indices; clean streams return
    ``{}`` (the fast path the benchmark measures)."""
    bs = int(batch_size)
    adds, dels = stream.adds, stream.dels
    per: Dict[int, Dict[str, int]] = {}

    def note(idx_arr, kind):
        b, c = np.unique(idx_arr // bs, return_counts=True)
        for bi, ct in zip(b.tolist(), c.tolist()):
            per.setdefault(int(bi), {})[kind] = \
                per.get(int(bi), {}).get(kind, 0) + int(ct)

    a_rows = np.arange(adds.shape[0])
    d_rows = np.arange(dels.shape[0])
    bad_a = np.zeros(adds.shape[0], bool)
    bad_d = np.zeros(dels.shape[0], bool)
    if adds.shape[0]:
        a_src, a_dst, a_w = adds[:, 0], adds[:, 1], adds[:, 2]
        bad_a = (a_src < 0) | (a_src >= n) | (a_dst < 0) | (a_dst >= n)
        if bad_a.any():
            note(a_rows[bad_a], "add_id_out_of_range")
        bw = _bad_w(a_w, ~bad_a)
        if bw.any():
            note(a_rows[bw], "weight_invalid")
    if dels.shape[0]:
        d_src, d_dst = dels[:, 0], dels[:, 1]
        bad_d = (d_src < 0) | (d_src >= n) | (d_dst < 0) | (d_dst >= n)
        if bad_d.any():
            note(d_rows[bad_d], "del_id_out_of_range")
    # per-batch add∩del conflicts via (batch, src, dst) key encoding
    if adds.shape[0] and dels.shape[0]:
        nn = max(int(n), 1)
        ga = a_rows[~bad_a] // bs
        gd = d_rows[~bad_d] // bs
        ka = (ga.astype(np.int64) * nn + adds[~bad_a, 0]) * nn \
            + adds[~bad_a, 1]
        kd = (gd.astype(np.int64) * nn + dels[~bad_d, 0]) * nn \
            + dels[~bad_d, 1]
        hit = np.isin(ka, kd)
        if hit.any():
            note(ga[hit] * bs, "add_del_conflict")

    out: Dict[int, List[Violation]] = {}
    for bi, kinds in per.items():
        out[bi] = [Violation(k, c) for k, c in sorted(kinds.items())]
    if bs > max_batch:
        for bi in range(stream.num_batches(bs)):
            out.setdefault(bi, []).append(
                Violation("batch_oversized", 1,
                          f"batch_size {bs} > max_batch {max_batch}"))
    return out


# ---------------------------------------------------------------------------
# The guard
# ---------------------------------------------------------------------------

class AdmissionGuard:
    """Per-session admission state: policy + limits + dead-letter buffer.

    ``admit`` returns the batch to apply (possibly sanitized under
    ``clamp``), ``None`` when the batch was quarantined, and raises
    :class:`AdmissionError` under ``reject``.  Counters live in the
    session's :class:`~repro_torch.runtime.health.SessionHealth`."""

    def __init__(self, policy: str = "clamp",
                 max_batch: int = DEFAULT_MAX_BATCH,
                 dead_letter: int = 64, health=None):
        if policy is None:
            policy = "off"
        if policy not in ADMISSION_POLICIES:
            raise ValueError(f"admission policy must be one of "
                             f"{ADMISSION_POLICIES}, got {policy!r}")
        self.policy = policy
        self.max_batch = int(max_batch)
        self.buffer = DeadLetterBuffer(dead_letter)
        self.health = health

    # -- single batch --------------------------------------------------------
    def admit(self, batch, n: int, cursor: int = 0,
              index: Optional[int] = None):
        if self.policy == "off":
            return batch
        reasons = batch_violations(batch, n, self.max_batch)
        if not reasons:
            if self.health is not None:
                self.health.admitted += 1
            return batch
        return self.resolve(batch, reasons, cursor, index, n)

    def resolve(self, batch, reasons: Sequence[Violation],
                cursor: int, index: Optional[int], n: int):
        """Apply the policy to a batch with known violations: returns
        the (sanitized) batch to apply, ``None`` if quarantined, raises
        under ``reject``."""
        if self.policy == "reject":
            if self.health is not None:
                self.health.rejected += 1
            err = AdmissionError(
                f"batch failed admission: "
                f"{', '.join(r.kind for r in reasons)}",
                reasons=reasons, batch_index=index)
            if self.health is not None:
                self.health.record_error(err)
            raise err
        if self.policy == "quarantine" or \
                not all(r.clampable for r in reasons):
            self.quarantine(batch, reasons, cursor, index)
            return None
        # clamp: a conflict-only batch is admitted UNTOUCHED (same
        # object, bit-exact — delete-before-add ordering is defined and
        # the paper's delete-then-re-add streams rely on it); anything
        # else admits the sanitized remainder
        if self.health is not None:
            self.health.conflicts += sum(
                r.count for r in reasons if r.kind == "add_del_conflict")
        if all(r.kind == "add_del_conflict" for r in reasons):
            if self.health is not None:
                self.health.admitted += 1
            return batch
        if self.health is not None:
            self.health.clamped += 1
            self.health.admitted += 1
        return sanitize_batch(batch, n)

    def quarantine(self, batch, reasons: Sequence[Violation],
                   cursor: int, index: Optional[int] = None) -> None:
        a = _host(batch.add_mask)
        d = _host(batch.del_mask)
        self.buffer.push(QuarantineRecord(
            reasons=tuple(reasons), cursor=cursor, index=index,
            n_adds=int(a.sum()), n_dels=int(d.sum()), batch=batch))
        if self.health is not None:
            self.health.quarantined += 1

    # -- whole stream --------------------------------------------------------
    def inspect_stream(self, stream, batch_size: int,
                       n: int) -> Dict[int, List[Violation]]:
        """Per-batch poison map for a stream.  Under ``clamp``,
        conflict-only batches are pre-filtered out (counted, admitted
        untouched) so the caller's fused fast path keeps them — the
        splice path is only for batches that actually need repair."""
        if self.policy == "off":
            return {}
        poison = stream_batch_violations(stream, batch_size, n,
                                         self.max_batch)
        if self.policy != "clamp" or not poison:
            return poison
        out: Dict[int, List[Violation]] = {}
        for bi, reasons in poison.items():
            if all(r.kind == "add_del_conflict" for r in reasons):
                if self.health is not None:
                    self.health.conflicts += sum(r.count for r in reasons)
            else:
                out[bi] = reasons
        return out
