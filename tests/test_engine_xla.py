"""The XLA device engine on the CPU backend: vmapped batch vs single-lane
parity on random shapes, the in-program densify, the integer seed count
table, the --engine auto rule and the persistent compile cache."""
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pomfret_tpu.kernels.engine_jax import (GapDeviceData, _seed_count_table,
                                            run_direction_device)
from pomfret_tpu.parallel.batch import (_densify_runs, _run_batch_jit,
                                        pack_gap_batch)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _random_lanes(rng, G=8):
    """Random lane batch: odd D, nc_cap == n_cand, empty lanes, all-seeded
    lanes, tiny R/S."""
    R = int(rng.integers(2, 7)) * 16
    S = int(rng.integers(1, 5)) * 32
    D = int(rng.choice([4, 8, 16]))
    n_cand = int(rng.integers(2, 17))
    nc_cap = ((n_cand + 15) // 16) * 16
    ids = rng.integers(-1, D, size=(G, R, S)).astype(np.int8)
    has_mmr = rng.random((G, R)) < 0.9
    ids[~has_mmr] = -1
    hp_init = np.full((G, R), 2, np.int32)
    n_seed = int(rng.integers(4, 12))
    hp_init[:, :n_seed] = rng.integers(0, 2, size=(G, n_seed))
    seed_ok = hp_init <= 1
    n_reads = rng.integers(0, R + 1, size=G).astype(np.int32)
    n_reads[0] = 0                       # dead lane
    n_reads[1] = R                       # full lane
    n_sites = rng.integers(1, S + 1, size=G).astype(np.int32)
    q_break = n_reads.copy()
    min0 = np.minimum(rng.integers(0, 4, size=G), n_sites - 1).astype(np.int32)
    max0 = np.minimum(min0 + rng.integers(0, 8, size=G),
                      n_sites - 1).astype(np.int32)
    cov = rng.integers(1, 6, size=G).astype(np.int32)
    args = (ids, has_mmr, hp_init, seed_ok, n_reads, n_sites, q_break,
            min0, max0, cov, np.full(G, n_cand, np.int32),
            np.full(G, 2 * R + 16, np.int32))
    return args, D, nc_cap


@pytest.mark.parametrize("seed", [42, 43, 44, 45])
def test_vmapped_engine_matches_single_lane_random_shapes(seed):
    """Randomized parity sweep: every lane of the vmapped batch engine
    equals the jitted single-lane run."""
    args, D, nc_cap = _random_lanes(np.random.default_rng(seed))
    hv = np.asarray(_run_batch_jit(*args, D=D, nc_cap=nc_cap))
    for g in range(hv.shape[0]):
        lane = [jnp.asarray(a[g]) for a in args]
        lane[0] = lane[0].astype(jnp.int32)
        h1 = np.asarray(run_direction_device(*lane, D=D, nc_cap=nc_cap))
        assert np.array_equal(hv[g], h1), f"seed {seed} lane {g}"
    assert (hv[0] == args[2][0]).all(), "a dead lane must not change"


def test_densify_runs_equals_dense_ids():
    """The device-side gather densify equals the host dense_ids() of the
    same runs lanes, including rows without mers and runs cut at S."""
    rng = np.random.default_rng(5)
    G, R, S, cb = 3, 40, 384, 256
    datas = []
    for _ in range(G):
        b0 = rng.integers(-1, S // 128, size=R).astype(np.int32)
        blk = rng.integers(0, 9, size=(R, cb)).astype(np.uint8)
        blk[b0 < 0] = 0
        perm = np.arange(R, dtype=np.int32)
        datas.append(GapDeviceData(
            ids=None, has_mmr=b0 >= 0, hp_init=np.full(R, 2, np.int32),
            seed_ok=np.zeros(R, bool), perm=perm, n_reads=R, n_sites=S,
            max_d=8, q_break=R, min0=0, max0=1, R=R, S=S, blk=blk, b0=b0))
    batch = pack_gap_batch(datas, [4] * G, n_cand=8, pad_g=G)
    assert batch.blk is not None
    dev = np.asarray(_densify_runs(jnp.asarray(batch.blk),
                                   jnp.asarray(batch.b0), S))
    for g, d in enumerate(datas):
        np.testing.assert_array_equal(dev[g], d.dense_ids().astype(np.int32))


def test_seed_count_table_matches_numpy():
    rng = np.random.default_rng(11)
    R, S, D = 50, 70, 8
    ids = rng.integers(-1, D, size=(R, S)).astype(np.int32)
    hp_init = rng.integers(0, 3, size=R).astype(np.int32)
    seed_ok = rng.random(R) < 0.8
    has_mmr = rng.random(R) < 0.9
    got = np.asarray(_seed_count_table(jnp.asarray(ids), jnp.asarray(hp_init),
                                       jnp.asarray(seed_ok),
                                       jnp.asarray(has_mmr), D))
    want = np.zeros((S, D, 2), np.float32)
    for r in range(R):
        if not (seed_ok[r] and has_mmr[r]) or hp_init[r] > 1:
            continue
        for s in range(S):
            if ids[r, s] >= 0:
                want[s, ids[r, s], hp_init[r]] += 1
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("backend,want", [("gpu", "jax"), ("cpu", "host")])
def test_engine_auto_resolution(monkeypatch, backend, want):
    from pomfret_tpu.pipeline import resolve_engine
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert resolve_engine("auto") == want
    assert resolve_engine("jax") == "jax"
    assert resolve_engine("host") == "host"


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_dir(tmp_path, env_set):
    """The persistent compile cache goes to JAX_COMPILATION_CACHE_DIR when
    it is set (and a compiled program lands there), else to the fixed
    <checkout>/.jax_cache."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    code = ("import jax, jax.numpy as jnp\n"
            "import pomfret_tpu.kernels.engine_jax\n"
            "print(jax.config.jax_compilation_cache_dir)\n")
    cache = tmp_path / "cc"
    if env_set:
        env["JAX_COMPILATION_CACHE_DIR"] = str(cache)
        code += ("jax.config.update("
                 "'jax_persistent_cache_min_compile_time_secs', 0)\n"
                 "jax.jit(lambda x: x * 3 + 1)(jnp.ones(7)).block_until_ready()\n")
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    got = r.stdout.strip().splitlines()[-1]
    if env_set:
        assert got == str(cache)
        assert cache.is_dir() and any(cache.iterdir())
    else:
        assert got == os.path.join(REPO, ".jax_cache")
