"""Batched/sharded engine tests on the 8-virtual-device CPU mesh."""
import numpy as np
import pytest

import jax

from pomfret_tpu.parallel.batch import make_gap_mesh, pack_gap_batch, run_gap_batch
from pomfret_tpu.kernels.engine_jax import run_direction_device


def _rand_gap(rng, R=64, S=96, D=8, n_reads=48):
    from pomfret_tpu.kernels.engine_jax import GapDeviceData
    ids = rng.integers(-1, D, size=(R, S)).astype(np.int32)
    ids[n_reads:, :] = -1
    has_mmr = np.zeros(R, dtype=bool)
    has_mmr[:n_reads] = True
    hp_init = np.full(R, 2, dtype=np.int32)
    hp_init[:16] = rng.integers(0, 2, size=16)
    seed_ok = hp_init <= 1
    perm = np.full(R, -1, dtype=np.int32)
    perm[:n_reads] = np.arange(n_reads)
    return GapDeviceData(ids=ids, has_mmr=has_mmr, hp_init=hp_init,
                         seed_ok=seed_ok, perm=perm,
                         n_reads=n_reads, n_sites=S, max_d=D, q_break=n_reads,
                         min0=0, max0=4)


def test_batch_matches_single():
    rng = np.random.default_rng(0)
    datas = [_rand_gap(rng) for _ in range(6)]
    covs = [4] * 6
    batch = pack_gap_batch(datas, covs, n_cand=8)
    out = run_gap_batch(batch, max_iters=160)
    for g, d in enumerate(datas):
        import jax.numpy as jnp
        hp = np.asarray(run_direction_device(
            jnp.asarray(d.ids), jnp.asarray(d.has_mmr), jnp.asarray(d.hp_init),
            jnp.asarray(d.seed_ok),
            jnp.int32(d.n_reads), jnp.int32(d.n_sites),
            jnp.int32(d.q_break), jnp.int32(d.min0), jnp.int32(d.max0),
            jnp.int32(4), jnp.int32(8), jnp.int32(160),
            D=batch.D, nc_cap=batch.nc_cap))
        assert np.array_equal(out[g], hp), f"gap {g} differs"


def test_mesh_sharded_matches_unsharded():
    assert len(jax.devices()) == 8, "conftest should provide 8 cpu devices"
    rng = np.random.default_rng(1)
    datas = [_rand_gap(rng) for _ in range(16)]
    covs = [4] * 16
    batch = pack_gap_batch(datas, covs, n_cand=8)
    out1 = run_gap_batch(batch, max_iters=160)
    mesh = make_gap_mesh(8)
    out8 = run_gap_batch(batch, mesh=mesh, max_iters=160)
    assert np.array_equal(out1, out8)


def _site_runs(d, rng):
    """Confine each read's mers to one contiguous site run, as real reads
    are (a read covers one stretch of the window)."""
    ids = d.ids.copy()
    S = ids.shape[1]
    for r in range(ids.shape[0]):
        lo = int(rng.integers(0, S - 1))
        hi = int(rng.integers(lo + 1, min(S, lo + 160) + 1))
        ids[r, :lo] = -1
        ids[r, hi:] = -1
    return type(d)(**{**d.__dict__, "ids": ids})


def _with_runs_layout(d):
    """The same lane in the compact runs layout: each row's covered sites
    as one 128-aligned block run (blk = id+1, 0 = absent)."""
    import dataclasses
    ids = d.dense_ids()
    R, S = ids.shape
    b0 = np.full(R, -1, dtype=np.int32)
    span = np.zeros(R, dtype=np.int64)
    for r in range(R):
        cov = np.flatnonzero(ids[r] >= 0)
        if len(cov):
            b0[r] = cov[0] // 128
            span[r] = cov[-1] + 1 - 128 * b0[r]
    cb = max(128, -(-int(span.max()) // 128) * 128)
    blk = np.zeros((R, cb), dtype=np.uint8)
    for r in np.flatnonzero(b0 >= 0):
        seg = ids[r, 128 * b0[r]: 128 * b0[r] + cb] + 1
        blk[r, : len(seg)] = seg
    return dataclasses.replace(d, ids=None, blk=blk, b0=b0, R=R, S=S)


@pytest.mark.parametrize("layout", ["dense", "runs"])
def test_mesh_shard_map_matches_unsharded(layout):
    """The mesh path (shard_map of the vmapped engine, one while_loop per
    device shard) equals the unsharded engine on the 8 virtual devices, in
    both upload layouts."""
    assert len(jax.devices()) == 8
    rng = np.random.default_rng(3)
    datas = [_site_runs(_rand_gap(rng, S=256), rng) for _ in range(16)]
    if layout == "runs":
        datas = [_with_runs_layout(d) for d in datas]
    batch = pack_gap_batch(datas, [4] * 16, n_cand=8, pad_g=64)
    assert (batch.blk is not None) == (layout == "runs")
    out1 = run_gap_batch(batch, max_iters=160)
    out8 = run_gap_batch(batch, mesh=make_gap_mesh(8), max_iters=160)
    assert np.array_equal(out1, out8)
    assert (out1[:16] <= 1).sum() > 0


def test_graft_entry():
    import sys
    sys.path.insert(0, "/root/repo")
    import __graft_entry__ as ge
    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    assert out.shape == (128,)
    ge.dryrun_multichip(8)


def test_pipeline_uses_local_mesh_and_matches_single_device(tmp_path,
                                                            monkeypatch):
    """The PRODUCTION methphase path (run_gaps_batched) must shard its gap
    batches over every local device (VERDICT r1 item 1) and produce outputs
    byte-identical to a single-device run."""
    from pomfret_tpu.cli import main as cli_main
    from pomfret_tpu.parallel import batch as pb
    from pomfret_tpu.testing import make_multi_block_scenario

    d = tmp_path / "mesh"
    d.mkdir()
    bam, vcf, truth = make_multi_block_scenario(str(d), n_blocks=3)
    args = ["-c", "50", "--engine", "jax", "--vcf", vcf, bam]

    p1 = str(d / "mesh8")
    assert cli_main(["methphase", "-o", p1, *args]) == 0
    assert pb.DISPATCH_STATS["n_devices_last"] == 8, \
        "production dispatch did not shard over the 8 local devices"
    assert pb.DISPATCH_STATS["lanes_last"] % 8 == 0

    monkeypatch.setenv("POMFRET_NO_MESH", "1")
    p2 = str(d / "single")
    assert cli_main(["methphase", "-o", p2, *args]) == 0
    assert pb.DISPATCH_STATS["n_devices_last"] == 1
    monkeypatch.delenv("POMFRET_NO_MESH")

    for ext in (".mp.gtf", ".mp.vcf"):
        b1 = open(p1 + ext, "rb").read()
        b2 = open(p2 + ext, "rb").read()
        assert b1 == b2, f"{ext} differs between 8-device mesh and single"


def test_engine_for_picks_the_layout_entry():
    """One device engine: the dense entry for a dense batch, the runs
    entry (in-program densify) for a runs batch."""
    from pomfret_tpu.parallel import batch as B
    rng = np.random.default_rng(7)
    dense = [_site_runs(_rand_gap(rng, S=256), rng) for _ in range(8)]
    b_d = pack_gap_batch(dense, [4] * 8, n_cand=8)
    b_r = pack_gap_batch([_with_runs_layout(d) for d in dense], [4] * 8,
                         n_cand=8)
    assert B._engine_for(b_d).func is B._run_batch_jit
    assert B._engine_for(b_r).func is B._run_batch_runs
    assert np.array_equal(run_gap_batch(b_d, max_iters=160),
                          run_gap_batch(b_r, max_iters=160))


def test_device_failure_propagates(tmp_path):
    """A failed device dispatch is not recomputed anywhere else: the error
    propagates, the methphase CLI exits non-zero and writes no outputs."""
    import os
    import subprocess
    import sys
    from pomfret_tpu.testing import make_multi_block_scenario

    bam, vcf, truth = make_multi_block_scenario(str(tmp_path), n_blocks=3)
    prefix = str(tmp_path / "out")
    code = (
        "import sys\n"
        "from pomfret_tpu.parallel import batch as pb\n"
        "def boom(*a, **k):\n"
        "    raise RuntimeError('simulated device failure')\n"
        "pb.run_gap_batch_async = boom\n"
        "from pomfret_tpu.cli import main\n"
        "sys.exit(main(sys.argv[1:]))\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [repo] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    r = subprocess.run(
        [sys.executable, "-c", code, "methphase", "-o", prefix, "-c", "50",
         "--engine", "jax", "--vcf", vcf, bam],
        env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode != 0
    assert "simulated device failure" in r.stderr
    assert not os.path.exists(prefix + ".mp.gtf")
