"""Preemption-safe checkpointing (counterpart of ``repro.ckpt.checkpoint``;
the on-disk layout is the same, so either package restores the other's
checkpoints).

Layout:  <dir>/step_<k>/
           manifest.json        — step, leaf count, caller metadata
           shard_<i>.npz        — flattened leaves, one file per host
           COMMITTED            — atomic-rename commit marker

Fault-tolerance contract (DESIGN.md §5):
  * every payload file (shard, manifest) is fsynced before the
    ``COMMITTED`` marker is created, the tmp directory is fsynced before
    the rename, and the parent directory is fsynced after it — a crash
    at ANY point leaves either the previous committed step or the new
    one, never a ``COMMITTED`` step with a truncated shard;
  * ``latest_step`` ignores uncommitted directories, so restart always
    resumes from the newest complete checkpoint;
  * leaves are numbered in JAX's pytree order (dict keys sorted,
    sequences in order), so ``leaf_i`` names the same leaf in both
    packages;
  * a leaf may be a numpy array or a tensor.  numpy has no bf16 here (no
    ``ml_dtypes``), so a bf16 tensor is saved as its raw 16-bit patterns
    (uint16) and the manifest's ``"dtypes"`` names it ``"bfloat16"``;
    restore turns it back into a bf16 tensor.  A bf16 leaf that ``repro``
    wrote (ml_dtypes' bfloat16, which reads back as 2-byte void without
    ml_dtypes) is read the same way.  Other leaves are stored as they
    are, so float32 checkpoints read in both packages; ``repro`` reads
    the port's bf16 leaves as the integers they are stored as.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
from typing import Any, Callable, List, Optional, Tuple

import numpy as np

from repro_torch.runtime.errors import CheckpointCorrupt

# Test seam for the crash-injection tests: when set, it is called with a
# named commit-protocol point ("shard", "manifest", "committed",
# "renamed") and may raise to simulate a kill at exactly that boundary.
# None in production.  The same points also cross the chaos harness's
# "checkpoint_write" seam (repro_torch.runtime.faults), which generalizes
# this hook; _crash_point stays for the commit-protocol tests.
_crash_point: Optional[Callable[[str], None]] = None


def _maybe_crash(point: str) -> None:
    from repro_torch.runtime import faults as _faults
    _faults.fire("checkpoint_write", point=point)
    if _crash_point is not None:
        _crash_point(point)


def _fsync_dir(path) -> None:
    """Durably record directory-entry changes (create/rename) on POSIX."""
    fd = os.open(str(path), os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _flatten(tree) -> Tuple[List[Any], Any]:
    """(leaves, structure) in JAX's pytree order: dict keys sorted,
    tuples and lists in order, None holding no leaf."""
    leaves: List[Any] = []

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        if isinstance(t, (tuple, list)):
            return type(t)(walk(v) for v in t)
        if t is None:
            return None
        leaves.append(t)
        return len(leaves) - 1

    return leaves, walk(tree)


def _unflatten(structure, leaves: List[Any]):
    if isinstance(structure, dict):
        return {k: _unflatten(v, leaves) for k, v in structure.items()}
    if isinstance(structure, (tuple, list)):
        return type(structure)(_unflatten(v, leaves) for v in structure)
    if structure is None:
        return None
    return leaves[structure]


def _bf16(x) -> bool:
    return hasattr(x, "detach") and str(x.dtype) == "torch.bfloat16"


def _host(x) -> np.ndarray:
    if hasattr(x, "detach"):                  # a torch tensor
        import torch
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:         # its raw bits
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    return np.asarray(x)


def _leaf(arr: np.ndarray, ex, bf16: bool):
    """A stored array as the example leaf ``ex`` holds it: a tensor of
    ex's dtype for a tensor example, else a numpy array of ex's dtype;
    ``bf16``: the array holds bf16 bit patterns."""
    if bf16 or hasattr(ex, "detach"):
        import torch
        if bf16:
            t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)
                                 .copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr))
        if hasattr(ex, "detach"):
            return t.to(ex.dtype)
        return t.float().numpy().astype(ex.dtype) if hasattr(ex, "dtype") \
            else t
    return np.asarray(arr, dtype=getattr(ex, "dtype", None))


def save(ckpt_dir, step: int, tree: Any, extra: Optional[dict] = None,
         host_id: int = 0, keep: int = 3):
    ckpt_dir = pathlib.Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    leaves, structure = _flatten(tree)
    arrays = {f"leaf_{i}": _host(x) for i, x in enumerate(leaves)}
    dtypes = {str(i): "bfloat16" for i, x in enumerate(leaves) if _bf16(x)}
    with open(tmp / f"shard_{host_id}.npz", "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    _maybe_crash("shard")
    manifest = {
        "step": step,
        "n_leaves": len(leaves),
        "treedef": json.dumps(structure),
        "extra": extra or {},
    }
    if dtypes:
        manifest["dtypes"] = dtypes
    with open(tmp / "manifest.json", "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    _maybe_crash("manifest")
    # the marker is created only after BOTH payload files are durable,
    # and is itself fsynced (file + directory entry) before the rename
    with open(tmp / "COMMITTED", "w") as f:
        f.flush()
        os.fsync(f.fileno())
    _fsync_dir(tmp)
    _maybe_crash("committed")
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)                      # atomic commit
    _fsync_dir(ckpt_dir)                       # make the rename durable
    _maybe_crash("renamed")
    _gc(ckpt_dir, keep)
    return final


def _committed_dirs(ckpt_dir: pathlib.Path):
    """Renamed, committed step directories only.  A crash between the
    marker write and the rename leaves a ``step_*.tmp`` dir that
    *contains* COMMITTED but was never renamed — the rename is the
    commit, so those must not count."""
    return [d for d in ckpt_dir.glob("step_*")
            if d.is_dir() and not d.name.endswith(".tmp")
            and (d / "COMMITTED").exists()]


def _gc(ckpt_dir: pathlib.Path, keep: int):
    steps = sorted(_committed_dirs(ckpt_dir))
    doomed = steps if keep <= 0 else steps[:-keep]
    for d in doomed:
        shutil.rmtree(d, ignore_errors=True)
    for d in ckpt_dir.glob("*.tmp"):
        shutil.rmtree(d, ignore_errors=True)


def latest_step(ckpt_dir) -> Optional[int]:
    ckpt_dir = pathlib.Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [int(d.name.split("_")[1]) for d in _committed_dirs(ckpt_dir)]
    return max(steps) if steps else None


def read_manifest(ckpt_dir, step: int) -> dict:
    """The manifest of a committed step (metadata only, no array I/O)."""
    d = pathlib.Path(ckpt_dir) / f"step_{step:08d}"
    if not (d / "COMMITTED").exists():
        raise FileNotFoundError(f"step {step} in {ckpt_dir} is not a "
                                f"committed checkpoint")
    try:
        return json.loads((d / "manifest.json").read_text())
    except (OSError, ValueError) as e:
        # committed marker present but payload unreadable: the commit
        # protocol's invariant was violated after the marker
        raise CheckpointCorrupt(
            f"committed step {step} has an unreadable manifest: {e}",
            path=d, step=step) from e


def restore(ckpt_dir, step: int, example_tree: Any,
            host_id: int = 0) -> Tuple[Any, dict]:
    """Restore into the structure of ``example_tree``: every leaf comes
    back on the host as its example leaf is (a tensor of its dtype, or a
    numpy array of its dtype; a bf16 leaf as a bf16 tensor); the caller
    places it on a device."""
    d = pathlib.Path(ckpt_dir) / f"step_{step:08d}"
    try:
        manifest = json.loads((d / "manifest.json").read_text())
    except (OSError, ValueError) as e:
        raise CheckpointCorrupt(
            f"step {step} has an unreadable manifest: {e}",
            path=d, step=step) from e
    leaves, structure = _flatten(example_tree)
    if manifest["n_leaves"] != len(leaves):
        raise CheckpointCorrupt(
            f"checkpoint has {manifest['n_leaves']} leaves, "
            f"restore tree has {len(leaves)}", path=d, step=step)
    new = []
    try:
        shard = np.load(d / f"shard_{host_id}.npz")
    except (OSError, ValueError) as e:
        raise CheckpointCorrupt(
            f"step {step} shard {host_id} is unreadable: {e}",
            path=d, step=step) from e
    # context-manage the NpzFile: a leaked zip fd per restore starves a
    # long-lived process of descriptors
    with shard as data:
        for i, ex in enumerate(leaves):
            try:
                arr = data[f"leaf_{i}"]
            except KeyError as e:
                raise CheckpointCorrupt(
                    f"step {step} shard {host_id} is missing leaf_{i}",
                    path=d, step=step) from e
            bf16 = manifest.get("dtypes", {}).get(str(i)) == "bfloat16" or \
                (arr.dtype.kind == "V" and arr.dtype.itemsize == 2)
            new.append(_leaf(arr, ex, bf16))
    return _unflatten(structure, new), manifest["extra"]
