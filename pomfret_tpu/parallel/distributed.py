"""Multi-host execution (SURVEY.md §5.8).

Design: hosts are peers in a jax.distributed job. The phase-gap index is
computed identically on every host from the same VCF (replicated, no
communication needed); gaps are assigned to hosts by a deterministic
round-robin over the global gap list (the gap — not the read — is the unit
of distribution, so no duplicate-read hazards). Each host loads only its own
gaps' BAM windows (BAI random access), runs the batched device engine on its
local chips, and the per-gap decisions + read tags are merged with a
jax.experimental.multihost_utils all-gather; the block-union
(lift_decisions) then runs replicated on every host, so host 0's output is
identical to a single-host run.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

import jax

# collective observability (tools/bench_scaling.py, VERDICT r4 #4): cumulative
# all-gather wall seconds and payload bytes THIS process contributed.
# Dumped with POMFRET_STATS_OUT so the scaling harness can decompose
# distribution overhead instead of publishing un-interpretable walls.
DIST_STATS = {"allgather_s": 0.0, "allgather_bytes": 0, "n_allgathers": 0}


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """jax.distributed.initialize from args or env
    (POMFRET_COORDINATOR / POMFRET_NUM_PROCS / POMFRET_PROC_ID)."""
    coordinator = coordinator or os.environ.get("POMFRET_COORDINATOR")
    if coordinator is None:
        return  # single-host
    num_processes = num_processes or int(os.environ["POMFRET_NUM_PROCS"])
    process_id = process_id if process_id is not None else int(os.environ["POMFRET_PROC_ID"])
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)


def assign_gaps(n_gaps: int, num_processes: int, process_id: int) -> List[int]:
    """Deterministic round-robin gap assignment (same on every host)."""
    return [i for i in range(n_gaps) if i % num_processes == process_id]


def allgather_decisions(local: Dict[int, int], n_gaps: int) -> np.ndarray:
    """All-gather per-gap decisions across hosts.

    local: {global gap index: decision} computed by this host. Returns the
    (n_gaps,) global decision vector, identical on every host. Uses a dense
    max-reduction (decisions are >= -1; unassigned slots carry -2).
    """
    vec = np.full(n_gaps, -2, dtype=np.int32)
    for i, d in local.items():
        vec[i] = d
    if jax.process_count() == 1:
        out = vec
    else:
        import time as _t
        from jax.experimental import multihost_utils
        _t0 = _t.perf_counter()
        gathered = multihost_utils.process_allgather(vec)  # (P, n_gaps)
        out = gathered.max(axis=0).astype(np.int32)
        DIST_STATS["allgather_s"] += _t.perf_counter() - _t0
        DIST_STATS["allgather_bytes"] += int(vec.nbytes)
        DIST_STATS["n_allgathers"] += 1
    # unassigned -> no-join (should not happen when assignment covers all)
    out[out == -2] = -1
    return out


def _pack_tag_map(local: Dict[str, int]) -> Tuple[np.ndarray, np.ndarray]:
    """Pack a qname->haptag map into two flat arrays for collective
    transport: a NUL-joined name byte blob (uint8) and the parallel tag
    vector (int32), names sorted for determinism. This replaces the round-1
    JSON-blob encoding (VERDICT r1 item 6a): no quoting/brace overhead, no
    per-entry JSON parse, merge memory O(total tags)."""
    names = sorted(local)
    tags = np.fromiter((local[qn] for qn in names), dtype=np.int32,
                       count=len(names))
    if names:
        blob = np.frombuffer(b"\0".join(qn.encode() for qn in names),
                             dtype=np.uint8).copy()
    else:
        blob = np.zeros(0, dtype=np.uint8)
    return blob, tags


def _merge_packed_tag_maps(blobs: Sequence[np.ndarray],
                           tag_arrays: Sequence[np.ndarray]) -> Dict[str, int]:
    """Merge per-process packed maps in process order; first process wins
    on conflicts (matches the reference's per-thread hash merge,
    blockjoin.c:4579-4595)."""
    merged: Dict[str, int] = {}
    for blob, tags in zip(blobs, tag_arrays):
        if len(tags) == 0:
            continue
        names = bytes(blob).split(b"\0")
        assert len(names) == len(tags), "packed tag map is inconsistent"
        for qn, t in zip(names, tags.tolist()):
            merged.setdefault(qn.decode(), t)
    return merged


def allgather_tag_maps(local: Dict[str, int]) -> Dict[str, int]:
    """All-gather qname->haptag maps; first process wins on conflicts
    (matches the reference's first-wins merge, blockjoin.c:4579-4595).
    Transport is two fixed-width arrays (name blob + tag vector) padded to
    the cross-host maximum, not a JSON blob."""
    if jax.process_count() == 1:
        return dict(local)
    import time as _t
    from jax.experimental import multihost_utils
    _t0 = _t.perf_counter()
    blob, tags = _pack_tag_map(local)
    # gather (blob_len, n_tags) first so each payload pads to the max
    lens = multihost_utils.process_allgather(
        np.array([len(blob), len(tags)], dtype=np.int64))  # (P, 2)
    lens = np.asarray(lens).reshape(-1, 2)
    mxb, mxt = int(lens[:, 0].max()), int(lens[:, 1].max())
    pb = np.zeros(mxb, dtype=np.uint8)
    pb[: len(blob)] = blob
    pt = np.zeros(mxt, dtype=np.int32)
    pt[: len(tags)] = tags
    all_blobs = multihost_utils.process_allgather(pb)   # (P, mxb)
    all_tags = multihost_utils.process_allgather(pt)    # (P, mxt)
    P = all_tags.shape[0]
    DIST_STATS["allgather_s"] += _t.perf_counter() - _t0
    DIST_STATS["allgather_bytes"] += int(pb.nbytes + pt.nbytes + 16)
    DIST_STATS["n_allgathers"] += 1
    return _merge_packed_tag_maps(
        [np.asarray(all_blobs[p, : int(lens[p, 0])]) for p in range(P)],
        [np.asarray(all_tags[p, : int(lens[p, 1])]) for p in range(P)])
