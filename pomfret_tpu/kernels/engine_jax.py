"""Device engine for the iterative meth-phasing loop.

Array-program reformulation of haplotag_region1 (blockjoin.c:3958-4080):

- host precomputes, per gap and direction, a dense (R, S) "mer id" grid:
  read r's methmer at site s mapped to a small per-site integer id
  (distinct methmers observed at a site are bounded by read coverage) —
  this replaces the C's per-site linear-scanned dictionaries
  (blockjoin.c:3453-3515);
- the device state is (cnt_table[S, D, 2], hp[R], loop counters); one
  lax.while_loop iteration = candidate gather -> score (gather + masked
  sum) -> commit best read (scatter-add) — static shapes throughout;
- the methmer valid range [min_i, max_i) is recomputed from its seed in
  closed form each iteration (counts grow monotonically, so this equals
  the reference's incremental extension, blockjoin.c:3669-3691);
- scores are float32 sums of count ratios; summation order inside a read
  is XLA's reduction order rather than the C's sequential order — decision
  equivalence is asserted against the host oracle in tests.

Batch over gaps with jax.vmap; shard the gap axis over a Mesh (parallel/).
"""
from __future__ import annotations

import functools
import os
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import jax
import jax.numpy as jnp

from ..core.engine_host import evaluate_separation
from ..core.methmer import (Methmers, get_methmer_sites_and_ranges,
                            store_mmr_of_reads, wipe_mmr_of_reads)
from ..core.readset import (READBACK, MmrConfig, ReadSet,
                            load_reads_given_interval)

INVALID_ID = -1


# <checkout>/.jax_cache: a fixed path, so the cache key stays stable
DEFAULT_COMPILE_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def _enable_compile_cache() -> None:
    """Persistent XLA compile cache, so each CLI process reuses the engine
    programs an earlier one compiled: JAX_COMPILATION_CACHE_DIR when set,
    otherwise DEFAULT_COMPILE_CACHE_DIR. Errors propagate."""
    d = os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_COMPILE_CACHE_DIR
    jax.config.update("jax_compilation_cache_dir", d)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


_enable_compile_cache()


# ---------------------------------------------------------------------------
# host-side packing
# ---------------------------------------------------------------------------

@dataclass
class GapDeviceData:
    """Per-(gap, direction) arrays for the device loop.

    Reads are stored PERMUTED into candidate-scan order (fwd: BAM order;
    bwd: descending end-position order) so the device loop needs no
    per-iteration indirection; `perm` maps device row -> original read id.

    The mer-id grid ships in ONE of two layouts:
    - dense: `ids` (R, S), -1 = absent (the original layout; also the
      int32 fallback when a site needs >127 dictionary entries);
    - runs: `blk` (R, CB) uint8 of id+1 (0 = absent) covering 128-site
      blocks [b0, b0 + CB/128), with `ids` None. A read's mers occupy one
      contiguous site run (~15% of S at production shapes), so this cuts
      host->device upload ~5x; the device rebuilds the dense grid with a
      one-hot block einsum (parallel/batch.py _densify_runs).
    """
    ids: Optional[np.ndarray]  # (R, S) int8/int32, -1 = absent; or None
    has_mmr: np.ndarray    # (R,) bool
    hp_init: np.ndarray    # (R,) int32 — post-wipe tags (step 1.5)
    seed_ok: np.ndarray    # (R,) bool — RAW haptag was 0/1 (may seed counts)
    perm: np.ndarray       # (R,) int32 — device row -> original read id
    n_reads: int
    n_sites: int
    max_d: int             # dense dictionary capacity actually used
    q_break: int
    min0: int
    max0: int
    R: int = 0             # padded row count (== ids.shape[0] when dense)
    S: int = 0             # padded site count (== ids.shape[1] when dense)
    blk: Optional[np.ndarray] = None   # (R, CB) uint8, id+1, 0 = absent
    b0: Optional[np.ndarray] = None    # (R,) int32 first block, -1 = none

    def __post_init__(self):
        if self.ids is not None and not self.R:
            self.R, self.S = self.ids.shape

    def dense_ids(self) -> np.ndarray:
        """Dense (R, S) grid from either layout (host-side; used by the
        dense pack path when a group mixes layouts, and by tests)."""
        if self.ids is not None:
            return self.ids
        # the runs layout holds ids up to 254 (id+1 in uint8); keep int8
        # for the common case, int16 when the dictionary is wider
        dt = np.int8 if self.max_d <= 127 else np.int16
        ids = np.full((self.R, self.S), -1, dtype=dt)
        cb = self.blk.shape[1]
        for r in np.flatnonzero(self.b0 >= 0):
            s0 = int(self.b0[r]) * 128
            hi = min(s0 + cb, self.S)
            if hi > s0:
                # via int16: id+1 may exceed the int8 range
                ids[r, s0:hi] = (self.blk[r, : hi - s0].astype(np.int16)
                                 - 1).astype(dt)
        return ids


def _grid_from_arrays(read_rows: np.ndarray, lens: np.ndarray,
                      start_is: np.ndarray, keys: np.ndarray,
                      inv_perm: np.ndarray, R: int, SP: int):
    """Dense per-site mer-id grid from per-read methmer arrays.

    read_rows/lens/start_is: one entry per read WITH methmers (original
    read ids, run lengths, first site indices); keys: their methmers
    concatenated in read order. Returns (ids, has_mmr, max_d)."""
    has_mmr = np.zeros(R, dtype=bool)
    if len(read_rows) == 0:
        return np.full((R, SP), INVALID_ID, dtype=np.int8), has_mmr, 1
    # scol[k] = read's mmr_start_i + within-read offset, one repeat+arange
    total = int(lens.sum())
    run_start = np.repeat(np.cumsum(lens) - lens, lens)
    rrow = np.repeat(read_rows, lens)
    scol = (np.repeat(start_is, lens)
            + np.arange(total, dtype=np.int64) - run_start)
    keys = keys.astype(np.int64)
    seq = np.arange(len(keys), dtype=np.int64)
    # a (site, key) pair's dense id is its first-appearance rank within the
    # site, matching the insertion order of the reference's per-site linear
    # dictionaries (mmr_t insert, blockjoin.c:3453-3486 — reads in storage
    # order, mers left to right). int8 grid when the dictionary fits: the
    # (R,SP) memset + the (G,R,S) batch copy are a quarter the bytes.
    order = np.lexsort((seq, keys, scol))
    ss, ks, qs = scol[order], keys[order], seq[order]
    new = np.empty(len(ss), dtype=bool)
    new[0] = True
    new[1:] = (ss[1:] != ss[:-1]) | (ks[1:] != ks[:-1])
    pair_of_triple = np.cumsum(new) - 1
    first_seq = qs[new]
    pair_site = ss[new]
    o2 = np.lexsort((first_seq, pair_site))
    m_pairs = len(o2)
    site_change = np.empty(m_pairs, dtype=bool)
    site_change[0] = True
    ps_sorted = pair_site[o2]
    site_change[1:] = ps_sorted[1:] != ps_sorted[:-1]
    grp_start = np.maximum.accumulate(
        np.where(site_change, np.arange(m_pairs), 0))
    rank_sorted = np.arange(m_pairs) - grp_start
    dense_of_pair = np.empty(m_pairs, dtype=np.int64)
    dense_of_pair[o2] = rank_sorted
    dense = np.empty(len(keys), dtype=np.int64)
    dense[order] = dense_of_pair[pair_of_triple]
    max_d = int(rank_sorted.max()) + 1
    dt = np.int8 if max_d <= 127 else np.int32
    ids = np.full((R, SP), INVALID_ID, dtype=dt)
    ids[inv_perm[rrow], scol] = dense.astype(dt)
    has_mmr[inv_perm[read_rows]] = True
    return ids, has_mmr, max_d


def _scan_perm(rs: ReadSet, direction: int, R: int):
    """(perm, inv_perm, q_break) for one direction's candidate-scan order."""
    n = rs.n
    if direction == 0:
        scan_list = list(range(n))
        q_break = n
    else:
        scan_list = [rs.rev_order[n - 1 - q] for q in range(n)]
        q_break = n - 1
    perm = np.full(R, -1, dtype=np.int32)
    perm[:n] = scan_list
    inv_perm = np.empty(n, dtype=np.int64)
    inv_perm[perm[:n]] = np.arange(n)
    return perm, inv_perm, q_break


def build_gap_device_data(rs: ReadSet, ms: Methmers, direction: int,
                          pad_r: Optional[int] = None,
                          pad_s: Optional[int] = None,
                          mmr_arrays=None,
                          want_runs: bool = False,
                          pre=None) -> GapDeviceData:
    """Pack one direction of one gap. Either store_mmr_of_reads(rs, ms) ran,
    or `mmr_arrays` carries the native batch-extraction result
    (core.methmer.extract_mmr_arrays) — the fast path skips the
    store/concat/wipe round-trip through the Read objects.

    want_runs: prefer the compact runs layout (blk/b0 set, ids None) for
    the batched device path; falls back to dense when the native lib is
    absent or a site needs >127 dictionary ids.

    pre: pack_group's batched pre-pass results for this lane —
    (perm, inv_perm, q_break, blk, b0, has_mmr, max_d) with blk/b0/has
    views into the group-wide mer_runs_multi output (max_d < 0 means the
    runs fill failed for this lane and the dense path below runs as
    usual, reusing the perm triple)."""
    n = rs.n
    S = ms.n
    R = pad_r or max(n, 1)
    SP = pad_s or max(S, 1)
    if pre is not None:
        perm, inv_perm, q_break = pre[0], pre[1], pre[2]
    else:
        perm, inv_perm, q_break = _scan_perm(rs, direction, R)

    blk = b0 = ids = None
    if pre is not None and pre[6] > 0 and want_runs \
            and not os.environ.get("POMFRET_NO_RUNS_UPLOAD"):
        blk, b0, has_mmr, max_d = pre[3], pre[4], pre[5], int(pre[6])
    elif mmr_arrays is not None:
        sel = np.flatnonzero(mmr_arrays["n"] > 0)
        lens = mmr_arrays["n"][sel].astype(np.int64)
        offs = mmr_arrays["off"][sel].astype(np.int64)
        starts = mmr_arrays["start_i"][sel].astype(np.int64)
        from ..io import native as _native
        res = None
        if not os.environ.get("POMFRET_NO_NATIVE_GRID"):
            if want_runs and not os.environ.get("POMFRET_NO_RUNS_UPLOAD"):
                cb = 128
                if len(sel):
                    cb = int(_round_up(int(((starts & 127) + lens).max()),
                                       128))
                rr = _native.mer_runs_fill(sel.astype(np.int64), lens,
                                           starts, offs,
                                           mmr_arrays["mers"], inv_perm,
                                           R, SP, cb)
                if rr is not None:
                    blk, b0, has_mmr, max_d = rr
            if blk is None:
                res = _native.mer_grid_fill(sel.astype(np.int64), lens,
                                            starts, offs,
                                            mmr_arrays["mers"], inv_perm,
                                            R, SP)
        if blk is not None:
            pass
        elif res is not None:
            ids, has_mmr, max_d = res
        else:
            # numpy oracle (also the >127-ids-per-site int32 path)
            total = int(lens.sum())
            gidx = (np.repeat(offs, lens)
                    + np.arange(total, dtype=np.int64)
                    - np.repeat(np.cumsum(lens) - lens, lens))
            ids, has_mmr, max_d = _grid_from_arrays(
                sel.astype(np.int64), lens, starts,
                mmr_arrays["mers"][gidx], inv_perm, R, SP)
    else:
        reads_with = [r for r in rs.reads if r.mmr_n]
        ids, has_mmr, max_d = _grid_from_arrays(
            np.array([r.i for r in reads_with], dtype=np.int64),
            np.array([r.mmr_n for r in reads_with], dtype=np.int64),
            np.array([r.mmr_start_i for r in reads_with], dtype=np.int64),
            np.concatenate([r.mmr for r in reads_with])
            if reads_with else np.zeros(0, dtype=np.int64),
            inv_perm, R, SP)

    # step 1 seeds (blockjoin.c:3976-4004)
    if direction == 0:
        ref_ids = rs.ids_left
        min0 = 0
        max0 = int(np.searchsorted(ms.sites_real_poss, rs.ref_start, side="right"))
    else:
        ref_ids = rs.ids_right
        max0 = S - 1
        min0 = S - 1
        for i in range(S - 1, -1, -1):
            if ms.sites_real_poss[i] > rs.ref_end:
                min0 -= 1
            else:
                break
    # step 1.5: wipe to unphased except ref side, with the hp&3 truncation
    # quirk (blockjoin.c:4013-4024). Seeding eligibility is tested on the
    # RAW haptag (insert_ref_reads..., blockjoin.c:3796) BEFORE truncation,
    # so e.g. HP:i:5 (hp=4, 4&3==0) must not seed the count table even
    # though its post-wipe state is 0 — matching the host oracle.
    # ids/has_mmr were built directly in scan (permuted) row order above;
    # hp/seed are tiny, so build in read order and permute
    hp_p = np.full(R, 2, dtype=np.int32)
    seed_p = np.zeros(R, dtype=bool)
    for rid in ref_ids:
        hp_p[inv_perm[rid]] = rs.reads[rid].hp & 3
        seed_p[inv_perm[rid]] = rs.reads[rid].hp in (0, 1)

    return GapDeviceData(ids=ids, has_mmr=has_mmr, hp_init=hp_p,
                         seed_ok=seed_p, perm=perm,
                         n_reads=n, n_sites=S, max_d=max_d, q_break=q_break,
                         min0=min0, max0=max0, R=R, S=SP, blk=blk, b0=b0)


# ---------------------------------------------------------------------------
# device kernel
# ---------------------------------------------------------------------------

def _range_from_seed(tot, cov, min0, max0, n_sites):
    """Closed-form update_available_methmer_range (blockjoin.c:3669-3691):
    min_i/max_i are the ends of the contiguous >=cov runs through the seeds;
    the site at max_i is then EXCLUDED by the query's exclusive bound."""
    S = tot.shape[0]
    idx = jnp.arange(S)
    ok = (tot >= cov) & (idx < n_sites)
    blocked_r = (~ok & (idx >= max0)) | (idx >= n_sites)
    fb = jnp.where(jnp.any(blocked_r), jnp.argmax(blocked_r), S)
    max_i = jnp.where(fb > max0, fb - 1, max0)
    blocked_l = ~ok & (idx <= min0) & (min0 >= 0)
    lnb = jnp.where(jnp.any(blocked_l), (S - 1) - jnp.argmax(blocked_l[::-1]), -1)
    min_i = jnp.where(min0 < 0, min0,
                      jnp.where(lnb == min0, min0,
                                jnp.where(lnb >= 0, lnb + 1, 0)))
    return min_i, max_i


def _seed_count_table(ids, hp_init, seed_ok, has_mmr, D: int):
    """Initial cnt_table from ref-seeded reads
    (insert_ref_reads_methmer_counts, blockjoin.c:3776-3810).

    Integer counts, one masked reduction over reads per (haplotype, id):
    exact whatever matmul precision the device defaults to, and nothing
    larger than (R, S) is materialized. (An integer scatter-add of the
    same counts serializes on its atomics: 235 ms vs 3.7 ms at G=512,
    R=512, S=1536, D=4 on an H100 at 700 W — PERF.md.)"""
    ok = seed_ok & has_mmr
    cols = []
    for t in (0, 1):
        ids_t = jnp.where(((hp_init == t) & ok)[:, None], ids, -1)  # (R, S)
        cols.append(jnp.stack([jnp.sum(ids_t == d, axis=0, dtype=jnp.int32)
                               for d in range(D)], axis=-1))
    # float32 count table: counts are small integers (exact in f32), and an
    # f32 table avoids a full-table cast inside every loop iteration
    return jnp.stack(cols, axis=-1).astype(jnp.float32)  # (S, D, 2)


def direction_step_fn(D: int, nc_cap: int):
    """Build (cond, body, init) closures for one direction run with dense
    dictionary capacity D and candidate-slot capacity nc_cap (the actual
    n_cand is a traced scalar <= nc_cap, so coverage-derived candidate batch
    sizes do not multiply compile signatures)."""

    def init(ids, hp_init, seed_ok, has_mmr):
        cnt0 = _seed_count_table(ids, hp_init, seed_ok, has_mmr, D)
        sums0 = cnt0.sum(axis=1)  # (S, 2), maintained incrementally
        return (hp_init, cnt0, sums0, jnp.int32(0), jnp.int32(0), jnp.int32(0))

    def cond(state, q_break, max_iters):
        hp, cnt, sums, q_last, failed, it = state
        return (q_last < q_break) & (failed <= 10) & (it < max_iters)

    def body(state, ids, has_mmr, n_reads, n_sites, min0, max0, cov, n_cand):
        # reads arrive permuted into scan order (host-side), so candidate
        # selection indexes rows directly
        hp, cnt, sums, q_last, failed, it = state
        R, S = ids.shape
        f32 = jnp.float32
        tot = sums.sum(axis=-1)                   # (S,)
        min_i, max_i = _range_from_seed(tot, cov, min0, max0, n_sites)

        # --- candidate collection (blockjoin.c:4037-4051) ---
        q = jnp.arange(R)
        untagged = (hp != 0) & (hp != 1)
        elig = untagged & (q >= q_last) & (q < n_reads)
        rank = jnp.cumsum(elig.astype(jnp.int32))
        sel = elig & (rank <= n_cand)
        # slot matrix: (R, NC) — row q goes to slot rank-1
        slot_mat = sel[:, None] & ((rank - 1)[:, None] == jnp.arange(nc_cap)[None, :])
        cand_valid = jnp.any(slot_mat, axis=0)                  # (NC,)
        cand_read = jnp.sum(slot_mat.astype(jnp.int32) * q[:, None],
                            axis=0)                             # (NC,) row idx

        # --- scoring (blockjoin.c:3487-3656) ---
        cids = jnp.take(ids, cand_read, axis=0)                 # (NC, S) rows
        covered = cids >= 0
        s_idx = jnp.broadcast_to(jnp.arange(S), cids.shape)
        in_range = (s_idx >= min_i) & (s_idx < max_i)
        # per-(cand, site) count lookup: D-unrolled selects fuse into one
        # elementwise kernel without materializing an (NC, S, D) one-hot
        cnt_c = jnp.zeros(cids.shape + (2,), f32)
        for d in range(D):
            cnt_c = cnt_c + (cids == d)[..., None] * cnt[None, :, d, :]
        found = (cnt_c.sum(axis=-1) > 0) & covered & in_range
        sums_b = sums[None, :, :]
        contrib = found[..., None] & (sums_b > 0)
        ratio = jnp.where(contrib, cnt_c / jnp.maximum(sums_b, 1.0), 0.0)
        score = ratio.sum(axis=1)                                # (NC, 2)
        l_found = contrib.sum(axis=1)
        l_total = l_found + (ratio > 0).sum(axis=1)              # score_l quirk
        diff = jnp.abs(score[:, 0] - score[:, 1])
        tag_ok = ~((diff < 3.0) & ((l_total[:, 0] < 3) | (l_total[:, 1] < 3)))
        tag = jnp.where(score[:, 0] > score[:, 1], 0, 1).astype(hp.dtype)
        has_mmr_c = jnp.take(has_mmr, cand_read)
        commit_ok = tag_ok & cand_valid & has_mmr_c

        # --- commit best (max score-diff; ties -> latest candidate slot,
        #     matching the stable-mergesort-from-the-end semantics at
        #     blockjoin.c:3729-3765) ---
        eff = jnp.where(commit_ok, diff, -1.0)
        best = jnp.max(eff)
        best_k = jnp.max(jnp.where(commit_ok & (eff == best),
                                   jnp.arange(nc_cap), -1))
        do_commit = best >= 0.0
        k = jnp.maximum(best_k, 0)
        rid = cand_read[k]
        t = tag[k]

        # masked (branch-free) commit of the chosen candidate's row
        rids = cids[k]                                           # (S,)
        upd = ((rids >= 0) & do_commit).astype(f32)              # (S,)
        rid_oh = jax.nn.one_hot(jnp.where(rids >= 0, rids, 0), D, dtype=f32)
        t_oh = jax.nn.one_hot(t, 2, dtype=f32)                   # (2,)
        delta = (upd[:, None] * rid_oh)[:, :, None] * t_oh[None, None, :]
        cnt = cnt + delta
        sums = sums + upd[:, None] * t_oh[None, :]
        hp = jnp.where((q == rid) & do_commit, t, hp)
        failed = jnp.where(do_commit, 0, failed + 1)
        q_last = jnp.where(do_commit, q_last, q_last + n_cand)
        return hp, cnt, sums, q_last, failed, it + 1

    return init, cond, body


def run_direction_core(ids, has_mmr, hp_init, seed_ok,
                       n_reads, n_sites, q_break, min0, max0, cov, n_cand,
                       max_iters, D: int, nc_cap: int = 16):
    """Pure (traceable) single-(gap,direction) run; returns final hp (R,).
    Shared by the jitted single-gap path, the vmapped batch path, and the
    sharded multi-chip path. n_cand and max_iters are traced scalars; only
    (shapes, D, nc_cap) key the compile cache."""
    init, cond, body = direction_step_fn(D, nc_cap)
    state = init(ids, hp_init, seed_ok, has_mmr)
    state = jax.lax.while_loop(
        lambda st: cond(st, q_break, max_iters),
        lambda st: body(st, ids, has_mmr, n_reads, n_sites, min0, max0, cov,
                        n_cand),
        state)
    return state[0]


@functools.partial(jax.jit, static_argnames=("D", "nc_cap"))
def run_direction_device(ids, has_mmr, hp_init, seed_ok,
                         n_reads, n_sites, q_break, min0, max0, cov, n_cand,
                         max_iters, D: int, nc_cap: int = 16):
    """Jitted single-(gap,direction) run; returns the final hp (R,)."""
    return run_direction_core(ids, has_mmr, hp_init, seed_ok, n_reads,
                              n_sites, q_break, min0, max0, cov, n_cand,
                              max_iters, D, nc_cap)


# ---------------------------------------------------------------------------
# gap-level wrapper (host orchestration mirroring haplotag_region2 / _given_bam)
# ---------------------------------------------------------------------------

def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _bucket_dim(n: int) -> int:
    """Pad a read/site dimension to a coarse shape bucket: multiples of 256
    up to 2048, then 1.25x steps rounded to 256. Keeps the number of
    distinct compiled programs small at modest padding waste."""
    b = _round_up(max(n, 1), 256)
    if b <= 2048:
        return b
    v = 2048
    while v < b:
        v = _round_up(int(v * 1.25), 256)
    return v


def _bucket_lanes(n: int) -> int:
    """Pad the lane count to a power-of-two multiple of 32, which bounds
    the compile signatures by batch size (dead lanes are inactive from
    iteration 0)."""
    v = 32
    while v < n:
        v *= 2
    return v


def run_gap_jax(rs: ReadSet, ms_fwd: Methmers, ms_bwd: Methmers,
                n_cand: int, cov_runtime: int,
                n_permutations: int = 1, rng=None) -> int:
    """Device-engine version of core.engine_host.haplotag_region
    (blockjoin.c:4288-4320): bwd then fwd, agreement gate.

    Permutation voting (haplotag_region2's restarts) runs as extra device
    dispatches: each permutation is just a different seed-tag vector, so the
    greedy loop itself is unchanged. Seed vectors come from the same
    glibc-exact drand48 stream (and stream order: all bwd permutes before
    fwd) as the host engine, so decisions are engine-independent."""
    from ..core.engine_host import make_permutation_seeds, vote_permutations

    if rs.n == 0 or ms_fwd.n == 0 or ms_bwd.n == 0:
        return -1
    initial = rs.store_haplotags()

    results = {}
    for direction, ms in ((1, ms_bwd), (0, ms_fwd)):
        store_mmr_of_reads(rs, ms)
        seeds, err_permutation = make_permutation_seeds(rs, direction,
                                                        n_permutations, rng)
        if err_permutation:
            # blockjoin.c:4160-4163: treat the direction as unphased
            results[direction] = (-1, None)
            rs.restore_haplotags(initial)
            wipe_mmr_of_reads(rs)
            continue
        # pad shapes to buckets to bound jit recompilation
        pad_r = _round_up(max(rs.n, 8), 128)
        pad_s = _round_up(max(ms.n, 8), 128)
        evals = []
        bufs = []
        for seed in seeds:
            rs.restore_haplotags(seed)
            dd = build_gap_device_data(rs, ms, direction, pad_r, pad_s)
            hp = np.asarray(run_direction_device(
                jnp.asarray(np.asarray(dd.ids, dtype=np.int32)),
                jnp.asarray(dd.has_mmr),
                jnp.asarray(dd.hp_init), jnp.asarray(dd.seed_ok),
                jnp.int32(dd.n_reads), jnp.int32(dd.n_sites),
                jnp.int32(dd.q_break), jnp.int32(dd.min0), jnp.int32(dd.max0),
                jnp.int32(cov_runtime), jnp.int32(n_cand),
                jnp.int32(2 * pad_r + 64),
                D=_round_up(dd.max_d, 16), nc_cap=_round_up(n_cand, 16)))
            # un-permute: device rows are in scan order
            hp_orig = np.full(rs.n, 2, dtype=np.int32)
            hp_orig[dd.perm[: rs.n]] = hp[: rs.n]
            rs.restore_haplotags(hp_orig[: rs.n])
            evals.append(evaluate_separation(rs, initial,
                                             1 if direction == 0 else 0))
            bufs.append(hp_orig[: rs.n].copy())
        join, chosen = vote_permutations(n_permutations, evals)
        results[direction] = (join, bufs[chosen] if join >= 0 else None)
        rs.restore_haplotags(initial)
        wipe_mmr_of_reads(rs)

    join2, _ = results[1]
    join1, tags_fwd = results[0]
    if join1 != join2 or (join1 == -1 and join2 == -1):
        rs.set_all_as_unphased()
        return -1
    rs.restore_haplotags(tags_fwd)
    return join1


def run_gaps_batched(st, bam, ref_name: str, rg, cfg: MmrConfig, n_cand: int,
                     indices=None, group: int = 0, n_permutations: int = 1,
                     perm_key_base: int = 0):
    """Pipeline hook (engine='jax'): run gaps of one chromosome (all, or
    the subset in `indices` for multi-host runs) through the batched device
    engine, `group` gaps (= 2*group lanes, fwd+bwd) per device dispatch.

    The default group of 128 amortizes the per-dispatch cost; the cost is
    that R/S padding is shared across the group. POMFRET_GAP_GROUP
    overrides.

    Returns (decisions, per-gap {qname: hp}) aligned with `indices`.

    Multi-chip: when this process has >1 local device, the lane axis of
    every group shards over a local-device mesh (parallel.batch.
    production_mesh) and the group size scales with the device count so
    each chip keeps its full lane block — one SPMD dispatch drives all
    local chips (VERDICT r1 item 1; the reference's kt_for-over-all-cores
    analog, blockjoin.c:4560).

    Permutation voting (n_permutations > 1): the N permutation seed
    vectors of each (gap, direction) ride as N extra lanes of the SAME
    batch (they share the ids grid — only hp_init/seed_ok differ,
    blockjoin.c:4115-4134), so voting costs ONE dispatch per group
    instead of N dispatches per gap. perm_key_base + gap_index seeds the
    per-gap srand48 stream (PARITY.md X7), identical to the host oracle's.
    """
    idxs = list(indices if indices is not None else range(len(rg.starts)))
    job = dict(ref_name=ref_name, rg=rg, cfg=cfg, n_cand=n_cand,
               indices=idxs, perm_key_base=perm_key_base)
    (decisions, tag_maps), = run_jobs_batched(
        st, bam, [job], group=group, n_permutations=n_permutations)
    return [decisions[i] for i in idxs], [tag_maps[i] for i in idxs]


def _pick_load_threads(bam) -> int:
    """Window loads overlap across gaps: the native decode path (inflate +
    bam_window_load) releases the GIL, so a small thread pool hides the
    Python-side assembly behind the C++ work. The serial fetch path mutates
    BgzfReader position state, so only the columnar path pools.

    bam_window_load is itself threaded (min(8, cpus+1) workers,
    io/native/__init__.py), so an outer pool only helps once there are
    cores beyond one call's workers — oversubscribing is actively
    harmful. POMFRET_LOAD_THREADS overrides."""
    import os as _os
    if getattr(bam, "fetch_window_columnar", None) is None or \
            _os.environ.get("POMFRET_NO_NATIVE_WINDOW"):
        return 1
    from ..io import native as _native
    if not _native.native_available():
        return 1
    return int(_os.environ.get(
        "POMFRET_LOAD_THREADS",
        max(1, min(4, (_os.cpu_count() or 2) // 8))))


def run_jobs_batched(st, bam, jobs, group: int = 0,
                     n_permutations: int = 1):
    """Run many chromosomes' gap jobs through ONE device pipeline.

    jobs: list of dicts {ref_name, rg, cfg, n_cand, indices, perm_key_base}.
    Returns a list of (decisions, tag_maps) dicts aligned with jobs.

    The one-deep async pipeline (device runs group k while the host loads
    and packs group k+1) spans JOB boundaries: the device never idles at a
    chromosome transition and the host never stalls on the last group of a
    chromosome before loading the next one's windows — the cross-chromosome
    overlap the round-1 pipeline lacked (VERDICT r1 item 2)."""
    import os as _os
    from ..parallel.batch import (DISPATCH_STATS, production_mesh,
                                  run_gap_batch_group_async)
    from ..utils.stats import stage
    mesh = production_mesh()
    n_dev = int(np.prod(mesh.devices.shape)) if mesh is not None else 1
    group = group or max(1, int(_os.environ.get("POMFRET_GAP_GROUP", "128"))
                         * n_dev // max(1, n_permutations))
    n_load_threads = _pick_load_threads(bam)
    results = [({}, {}) for _ in jobs]  # (decisions, tag_maps) per job

    # the ordered plan of (job index, gap-index chunk) groups
    plan = []
    for ji, job in enumerate(jobs):
        idxs = job["indices"]
        for c0 in range(0, len(idxs), group):
            plan.append((ji, idxs[c0 : c0 + group]))

    src_state = {"ji": None, "src": None}  # producer-local, one job at a time

    def _chrom_source(ji):
        """Window-union columnar source for job ji, or None.

        Decodes the UNION of this job's gap windows' ±READBACK halos in
        one segmented pass — each halo-overlapping record once, for ANY
        window set: dense window sets (most of the chromosome) behave like
        the old whole-chrom scan, and sparse WGS-shaped sets never decode
        (or inflate) the space between gaps, which the round-3
        50%-of-chromosome sum gate never served (VERDICT r3 #1).
        POMFRET_NO_CHROM_SCAN=1 restores per-window loads."""
        if src_state["ji"] == ji:
            return src_state["src"]
        src_state["ji"] = ji
        src_state["src"] = None
        job = jobs[ji]
        tid = bam.ref_id(job["ref_name"]) if hasattr(bam, "ref_id") else -1
        if tid < 0:
            return None
        ref_len = bam.ref_lens[tid]
        rg = job["rg"]
        # -1: the per-window fetch queries [start-READBACK-1, end+READBACK)
        # (load_reads_given_interval's 1-based lo), so the union must too
        halos = sorted(
            (max(rg.starts[i] - READBACK - 1, 0),
             min(rg.ends[i] + READBACK, ref_len))
            for i in job["indices"])
        regions = []
        for lo, hi in halos:
            if regions and lo <= regions[-1][1]:
                regions[-1][1] = max(regions[-1][1], hi)
            else:
                regions.append([lo, hi])
        if sum(hi - lo for lo, hi in regions) >= 0.98 * ref_len:
            regions = None  # effectively the whole chromosome
        from ..core.readset import ChromReadSource
        src = ChromReadSource(bam, job["ref_name"], job["cfg"],
                              regions=regions)
        src_state["src"] = src if src.ok else None
        return src_state["src"]

    def _load_chunk(ji, chunk):
        job = jobs[ji]
        ref_name, rg, cfg = job["ref_name"], job["rg"], job["cfg"]

        def _load_one(i, src=None):
            import time as _t
            t0 = _t.perf_counter()
            if src is not None:
                rs = src.window(rg.starts[i], rg.ends[i], READBACK,
                                st.qname2haptag_raw if st.stores_raw_tag
                                else None)
            else:
                rs = load_reads_given_interval(
                    bam, ref_name, rg.starts[i], rg.ends[i], READBACK, cfg,
                    st.qname2haptag_raw if st.stores_raw_tag else None)
            t1 = _t.perf_counter()
            ms_fwd = get_methmer_sites_and_ranges(rs, cfg, 0)
            ms_bwd = get_methmer_sites_and_ranges(rs, cfg, 1)
            t2 = _t.perf_counter()
            from ..utils.stats import add_stage
            add_stage("wl_materialize", t1 - t0)
            add_stage("wl_sites", t2 - t1)
            return i, rs, ms_fwd, ms_bwd

        with stage("window_load"):
            # sub-stage attribution (wl_*): source build vs per-window
            # materialization vs methmer site selection — the at-scale
            # breakdown VERDICT r4 asked for (cumulative, overlaps pack
            # under the prefetch producer like every other stage)
            with stage("wl_source"):
                src = _chrom_source(ji)
            if src is not None:
                with stage("wl_window"):
                    return [_load_one(i, src) for i in chunk]
            if n_load_threads > 1 and len(chunk) > 1:
                import concurrent.futures as _fut
                with _fut.ThreadPoolExecutor(n_load_threads) as ex:
                    return list(ex.map(_load_one, chunk))
            return [_load_one(i) for i in chunk]

    # Window loading spends most of its time in GIL-releasing native calls
    # (inflate + bam_window_load), so a single background producer thread
    # loads group k+1..k+depth while the main thread packs/dispatches/
    # decides group k — real parallelism, not time-slicing. Depth is small:
    # each in-flight group holds its windows' read arrays in RAM.
    # POMFRET_PREFETCH=0 restores the serial order (identical results
    # either way: the plan order, and per-group contents, are unchanged).
    # Default OFF below 4 cores: the load stage is mostly numpy
    # (GIL-holding), so on a 2-core host the producer thread just
    # time-slices against pack/decide.
    default_depth = "2" if (_os.cpu_count() or 2) >= 4 else "0"
    depth = int(_os.environ.get("POMFRET_PREFETCH", default_depth))
    if depth > 0 and len(plan) > 1:
        import queue as _queue
        import threading as _threading
        import time as _time
        q: "_queue.Queue" = _queue.Queue(maxsize=depth)

        def _producer():
            # producer-side stall accounting: put_wait ~= time the loader
            # sat on a full queue (consumer is the bottleneck); the
            # consumer's get_wait is the mirror (loader is the bottleneck).
            # Both land in DISPATCH_STATS for the prefetch-path artifact
            # (VERDICT r4 #8).
            try:
                for ji, chunk in plan:
                    item = (ji, chunk, _load_chunk(ji, chunk), None)
                    t0 = _time.perf_counter()
                    q.put(item)
                    DISPATCH_STATS["prefetch_put_wait_s"] += \
                        _time.perf_counter() - t0
            except BaseException as e:  # surface in the consumer
                q.put((None, None, None, e))

        t = _threading.Thread(target=_producer, name="pomfret-loader",
                              daemon=True)
        t.start()

        def _iter_groups():
            for _ in range(len(plan)):
                t0 = _time.perf_counter()
                ji, chunk, loads, err = q.get()
                DISPATCH_STATS["prefetch_get_wait_s"] += \
                    _time.perf_counter() - t0
                DISPATCH_STATS["prefetch_groups"] += 1
                DISPATCH_STATS["prefetch_queue_depth_sum"] += q.qsize()
                if err is not None:
                    raise err
                yield ji, loads
            t.join()
    else:
        def _iter_groups():
            for ji, chunk in plan:
                yield ji, _load_chunk(ji, chunk)

    # device pipeline across ALL jobs: up to POMFRET_PIPE_DEPTH groups
    # in flight before the oldest is drained, so dispatch and download
    # overlap the next group's load+pack; each in-flight group holds its
    # packed arrays in RAM.
    pipe_depth = max(1, int(_os.environ.get("POMFRET_PIPE_DEPTH", "2")))
    pending = []
    for ji, loads in _iter_groups():
        job = jobs[ji]
        decisions, tag_maps = results[ji]
        loaded = []
        for i, rs, ms_fwd, ms_bwd in loads:
            DISPATCH_STATS["window_reads"] += int(rs.n)
            if rs.n == 0 or ms_fwd.n == 0 or ms_bwd.n == 0:
                decisions[i] = -1
                tag_maps[i] = {}
                continue
            loaded.append((i, rs, ms_fwd, ms_bwd))
        if not loaded:
            continue
        rngs = None
        if n_permutations > 1:
            from ..core.engine_host import Drand48
            rngs = [Drand48.from_srand48(job["perm_key_base"] + i)
                    for i, *_ in loaded]
        with stage("pack"):
            datas, parts, errs = pack_group(loaded, job["cfg"],
                                            job["n_cand"],
                                            lane_multiple=n_dev,
                                            n_permutations=n_permutations,
                                            rngs=rngs)
        # in-flight groups only need hp/qname/boundary state for the
        # decide step — drop each window's concat memo (the largest
        # per-window COPY, ~2 MB on dense windows) now that packing
        # consumed it (scale-5 RSS thread).
        for _li, _rs, _mf, _mb in loaded:
            _rs._calls_concat = None
            _rs._site_sel_cache = None
        # dispatch asynchronously: the device crunches this group while
        # the host loads and packs the next one (download deferred). A
        # device failure propagates: --resume is the recovery path.
        with stage("dispatch"):
            fut = run_gap_batch_group_async(parts, mesh=mesh,
                                            n_lanes=len(datas))
        import time as _time
        DISPATCH_STATS.setdefault("group_intervals", []).append(
            [_time.perf_counter(), None])  # drain time filled at drain
        pending.append((ji, loaded, datas, errs, fut,
                        len(DISPATCH_STATS["group_intervals"]) - 1))
        if len(pending) > pipe_depth:
            _drain_pending(pending.pop(0), results, n_permutations)
    while pending:
        _drain_pending(pending.pop(0), results, n_permutations)
    return results


def _drain_pending(entry, results, n_permutations: int) -> None:
    """Drain one in-flight group and stamp its dispatch->drain interval."""
    import time as _time
    from ..parallel.batch import DISPATCH_STATS
    ji, loaded, datas, errs, fut, iv_idx = entry
    _drain_group((loaded, datas, errs, fut), *results[ji], n_permutations)
    DISPATCH_STATS["group_intervals"][iv_idx][1] = _time.perf_counter()


def _reseeded(dd: GapDeviceData, rs: ReadSet, direction: int,
              seed_tags: np.ndarray) -> GapDeviceData:
    """Clone a packed lane with hp_init/seed_ok derived from a permutation
    seed-tag vector: the N permutation lanes of one (gap, direction) share
    the ids grid/has_mmr/perm — only the boundary seeds differ
    (permute_haplotags swaps tags between boundary reads,
    blockjoin.c:4115-4134). Seeding semantics match build_gap_device_data:
    hp & 3 truncation for the wipe state, raw-tag-in-{0,1} gate for count
    seeding (blockjoin.c:3796, 4013-4024)."""
    import dataclasses
    n = rs.n
    inv_perm = np.empty(n, dtype=np.int64)
    inv_perm[dd.perm[:n]] = np.arange(n)
    ref_ids = rs.ids_left if direction == 0 else rs.ids_right
    hp_p = np.full(dd.R, 2, dtype=np.int32)
    seed_p = np.zeros(dd.R, dtype=bool)
    for rid in ref_ids:
        t = int(seed_tags[rid])
        hp_p[inv_perm[rid]] = t & 3
        seed_p[inv_perm[rid]] = t in (0, 1)
    return dataclasses.replace(dd, hp_init=hp_p, seed_ok=seed_p)


def pack_group(loaded, cfg: MmrConfig, n_cand: int, lane_multiple: int = 1,
               n_permutations: int = 1, rngs=None):
    """Pack one group of loaded (i, rs, ms_fwd, ms_bwd) windows into a
    device batch: both directions ride ONE dispatch (lanes [0:n) bwd,
    [n:2n) fwd; with permutation voting each (gap, direction) contributes
    n_permutations consecutive lanes). Pads use the coarse bucket ladder,
    NOT tight round-up: each distinct (G,R,S) is a fresh compile of the
    engine, so a handful of stable shapes beats minimal padding. Shared by run_gaps_batched and main_warmup — warmup
    compiles exactly the shapes real runs will request.

    lane_multiple: pad the lane count to a multiple of this (the mesh
    device count) so the lane axis shards evenly. Power-of-two device
    counts <=32 already divide every bucket; odd counts pad further.

    rngs: per-gap Drand48 streams (required when n_permutations > 1);
    each gap's stream is consumed bwd-permutes-then-fwd-permutes, the
    same order as the host oracle within a gap (PARITY.md X7).

    Returns (per-lane datas, parts, errs): parts is a list of
    (lane_indices, GapBatch) — one entry for a layout-homogeneous group
    (the common case), TWO when the group mixes runs-eligible and
    dense-only lanes. A mixed group ships the runs lanes compactly and
    only the high-D lanes dense, instead of reverting the whole group to
    the dense upload that was the round-3 device_wait bottleneck (one
    >254-ids-per-site gap re-inflated the upload ~4x; the reference
    derives per-chromosome coverage parameters for exactly this
    heterogeneity, blockjoin.c:4358-4392). errs is the set of
    (gap_index_in_loaded, direction) whose permute failed (empty boundary
    list) — those directions decide -1, blockjoin.c:4160-4163."""
    from ..core.engine_host import make_permutation_seeds
    from ..parallel.batch import pack_gap_batch

    if n_permutations > 1:
        assert rngs is not None and len(rngs) == len(loaded), \
            "per-gap rng streams are required for batched permutation voting"
    pad_r = _bucket_dim(max(rs.n for _, rs, _, _ in loaded))
    pad_s = _bucket_dim(max(max(t[2].n, t[3].n) for t in loaded))
    datas = []
    errs = set()
    # batch ALL (gap, direction) methmer extractions of the group into ONE
    # native call (mmr_extract_multi): the per-lane call paid a ctypes
    # round trip + thread spawn ~2G times per group and was the dominant
    # pack cost; the batched call drains lanes over one worker pool
    # (VERDICT r4 #1). Falls back to the per-lane path when unavailable.
    multi = None
    if not os.environ.get("POMFRET_NO_NATIVE_MMR"):
        from ..io import native as _native
        if _native.native_available():
            tasks = []
            for direction in (1, 0):
                for _, rs, ms_fwd, ms_bwd in loaded:
                    ms = ms_fwd if direction == 0 else ms_bwd
                    calls, quals, call_off, call_n = rs.concat_calls()
                    tasks.append((ms.sites_starts, ms.mmr_lens, calls,
                                  quals, call_off, call_n))
            multi = _native.mmr_extract_multi(tasks)
    # second batched pre-pass: every lane's runs-layout fill in ONE native
    # call (mer_runs_multi) writing one (T, R, CB) block array — replaces
    # the per-lane mer_runs_fill call + fresh np.zeros. Lanes whose fill
    # fails (>254 ids) keep pre[6] < 0 and take the dense path inside
    # build_gap_device_data as before.
    pres = None
    if multi is not None and not os.environ.get("POMFRET_NO_RUNS_UPLOAD"):
        from ..io import native as _native
        z64 = np.zeros(0, dtype=np.int64)
        fill_tasks, metas = [], []
        cb_need = 128
        for k, res in enumerate(multi):
            direction = 1 if k < len(loaded) else 0
            _, rs, _, _ = loaded[k % len(loaded)]
            if res is None:
                metas.append(None)
                fill_tasks.append((z64, z64, z64, z64,
                                   np.zeros(0, dtype=np.uint32), z64))
                continue
            perm, inv_perm, q_break = _scan_perm(rs, direction, pad_r)
            sel = np.flatnonzero(res["n"] > 0).astype(np.int64)
            lens = res["n"][sel].astype(np.int64)
            offs = res["off"][sel].astype(np.int64)
            starts = res["start_i"][sel].astype(np.int64)
            if len(sel):
                cb_need = max(cb_need, int(((starts & 127) + lens).max()))
            metas.append((perm, inv_perm, q_break))
            fill_tasks.append((sel, lens, starts, offs, res["mers"],
                               inv_perm))
        rr = _native.mer_runs_multi(fill_tasks, pad_r, pad_s,
                                    _round_up(cb_need, 128))
        if rr is not None:
            blk_all, b0_all, has_all, maxd = rr
            pres = [None if metas[k] is None else
                    metas[k] + (blk_all[k], b0_all[k], has_all[k],
                                int(maxd[k]))
                    for k in range(len(multi))]
    for direction in (1, 0):
        for j, (i, rs, ms_fwd, ms_bwd) in enumerate(loaded):
            ms = ms_fwd if direction == 0 else ms_bwd
            k = (0 if direction == 1 else len(loaded)) + j
            if multi is not None:
                res = multi[k]
            else:
                from ..core.methmer import extract_mmr_arrays
                res = extract_mmr_arrays(rs, ms)
            if res is not None:
                dd = build_gap_device_data(rs, ms, direction, pad_r, pad_s,
                                           mmr_arrays=res, want_runs=True,
                                           pre=pres[k] if pres is not None
                                           else None)
            else:
                store_mmr_of_reads(rs, ms)
                dd = build_gap_device_data(rs, ms, direction, pad_r, pad_s)
                wipe_mmr_of_reads(rs)
            if n_permutations == 1:
                datas.append(dd)
                continue
            seeds, err = make_permutation_seeds(rs, direction,
                                                n_permutations, rngs[j])
            if err:
                errs.add((j, direction))
            while len(seeds) < n_permutations:
                # failed permute: keep the lane grid rectangular with dead
                # copies of run 0 (their results are discarded via errs)
                seeds.append(seeds[0])
            datas.append(dd)  # run 0 = the initial tags
            for seed in seeds[1:]:
                datas.append(_reseeded(dd, rs, direction, seed))
    def _pad_lanes(n: int) -> int:
        p = _bucket_lanes(n)
        if lane_multiple > 1 and p % lane_multiple:
            import math
            p = _round_up(p, math.lcm(32, lane_multiple))
        return p

    eligible = [d.blk is not None for d in datas]
    if all(eligible) or not any(eligible):
        lanes = [np.arange(len(datas))]
    else:  # mixed layouts: one sub-batch per layout (see docstring)
        lanes = [np.flatnonzero(eligible),
                 np.flatnonzero([not e for e in eligible])]
    parts = []
    for idx in lanes:
        sub = [datas[i] for i in idx]
        parts.append((idx, pack_gap_batch(
            sub, [cfg.cov_for_runtime] * len(sub), n_cand,
            pad_g=_pad_lanes(len(sub)))))
    return datas, parts, errs


def _drain_group(entry, decisions, tag_maps, n_permutations: int = 1) -> None:
    """Download one finished group and run the host-side decision step:
    per (gap, direction) evaluate each permutation lane's separation, vote
    (vote_permutations — with N=1 this reduces to the score>=2/which_way
    gate of haplotag_region2's single run), then apply the fwd/bwd agreement
    gate (blockjoin.c:4288-4320)."""
    from ..core.engine_host import vote_permutations
    from ..utils.stats import stage

    from ..parallel.batch import DISPATCH_STATS

    loaded, datas, errs, fut = entry
    import time as _t
    _w0 = _t.perf_counter()
    with stage("device_wait"):
        out = np.asarray(fut)  # blocks until the device batch finishes
    DISPATCH_STATS["device_wait_s"] += _t.perf_counter() - _w0
    DISPATCH_STATS["gaps_decided"] += len(loaded)
    DISPATCH_STATS["real_lanes"] += len(datas)
    n_loaded = len(loaded)
    N = n_permutations
    import time as _time
    t_decide = _time.perf_counter()
    for j, (i, rs, _, _) in enumerate(loaded):
        initial = rs.store_haplotags()
        results: Dict[int, tuple] = {}
        for k, direction in enumerate((1, 0)):
            if (j, direction) in errs:
                results[direction] = (-1, None)
                continue
            evals, bufs = [], []
            for p in range(N):
                lane = (k * n_loaded + j) * N + p
                dd = datas[lane]
                hp = out[lane]
                hp_orig = np.full(rs.n, 2, dtype=np.int32)
                hp_orig[dd.perm[: rs.n]] = hp[: rs.n]
                rs.restore_haplotags(hp_orig)
                evals.append(evaluate_separation(
                    rs, initial, 1 if direction == 0 else 0))
                bufs.append(hp_orig)
                rs.restore_haplotags(initial)
            join, chosen = vote_permutations(N, evals)
            results[direction] = (join, bufs[chosen] if join >= 0 else None)
        join2, _ = results[1]
        join1, tags_fwd = results[0]
        if join1 != join2 or (join1 == -1 and join2 == -1):
            rs.set_all_as_unphased()
            d = -1
        else:
            rs.restore_haplotags(tags_fwd)
            d = join1
        decisions[i] = d
        tag_maps[i] = {r.qname: r.hp for r in rs.reads} if d >= 0 else {}
    from ..utils.stats import add_stage
    add_stage("decide", _time.perf_counter() - t_decide)
