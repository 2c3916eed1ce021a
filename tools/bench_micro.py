"""Microbenchmark of the XLA device engine at two shapes, on the GPU.

    python tools/bench_micro.py [--out DIR]

Shapes:
  loop   the device-loop shape of bench.py: G=512 lanes of the two-block
         scenario's gap window (D=4, NC=16);
  dense  one dense gap window of ~1.6k reads (testing.DENSE_CHROM; the
         WGS-60x window size), both directions replicated to G=32 lanes
         (R=1792, D=8, NC=64).

Per shape: wall of a full engine run (median of 5, after a warm-up), time
per loop iteration (slope between two max_iters values below convergence,
same executable), the compiled program's memory analysis, peak device
memory, and the top device ops of one traced full run (jax.profiler;
summed device durations per op name). Writes <out>/bench_micro.json and
the traces under <out>/trace_<shape>/. Needs a GPU.
"""
import argparse
import glob
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def loop_batch():
    from bench import build_real_gap_batch
    batches, n_reads = build_real_gap_batch(512)
    return batches[0], n_reads


def dense_batch():
    from pomfret_tpu.core.methmer import get_methmer_sites_and_ranges
    from pomfret_tpu.core.readset import (READBACK, MmrConfig,
                                          load_reads_given_interval)
    from pomfret_tpu.io.cram import open_alignment
    from pomfret_tpu.kernels.engine_jax import pack_group
    from pomfret_tpu.pipeline import (_derive_chrom_params,
                                      estimate_read_coverage_cached)
    from pomfret_tpu.testing import DENSE_CHROM, make_scale_dataset
    with tempfile.TemporaryDirectory() as d:
        bam, vcf, _ = make_scale_dataset(
            d, dict(n_blocks=2, block_len=60_000, gap_len=30_000,
                    per_chrom=[DENSE_CHROM]), bam_threads=4)
        cov = estimate_read_coverage_cached(bam, 4)["chr1"]
        cfg, n_cand = _derive_chrom_params(MmrConfig(), 15, cov, "chr1")
        # the gap window: block 1's last variant to block 2's first
        from pomfret_tpu.core.intervals import (Storage, merge_close_intervals,
                                                store_raw_intervals)
        from pomfret_tpu.io.intervals_loader import (IS_VCF,
                                                     load_intervals_from_file)
        st = Storage()
        load_intervals_from_file(vcf, IS_VCF, st)
        rg = st.ranges[0]
        store_raw_intervals(rg)
        merge_close_intervals(rg, READBACK)
        rs = load_reads_given_interval(open_alignment(bam), "chr1",
                                       rg.starts[0], rg.ends[0], READBACK,
                                       cfg)
        mf = get_methmer_sites_and_ranges(rs, cfg, 0)
        mb = get_methmer_sites_and_ranges(rs, cfg, 1)
        _, parts, _ = pack_group([(0, rs, mf, mb)] * 16, cfg, n_cand)
    assert len(parts) == 1
    return parts[0][1], rs.n


def top_device_ops(trace_dir, k=12):
    """Summed device durations per op name over the device planes of the
    newest trace under trace_dir."""
    from jax.profiler import ProfileData
    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    pd = ProfileData.from_file(path)
    per_line = {}
    for plane in pd.planes:
        if not plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            tot = {}
            for ev in line.events:
                n, c = tot.get(ev.name, (0.0, 0))
                tot[ev.name] = (n + ev.duration_ns, c + 1)
            top = sorted(tot.items(), key=lambda kv: -kv[1][0])[:k]
            per_line[f"{plane.name} | {line.name}"] = [
                {"op": name, "total_us": ns / 1e3, "count": c}
                for name, (ns, c) in top]
    return per_line


def measure(name, batch, n_reads, out):
    import jax
    from pomfret_tpu.parallel.batch import _engine_for, batch_args

    G, R, S = batch.shape3
    f = _engine_for(batch)

    def args_for(iters):
        return [jax.device_put(a) for a in batch_args(batch, iters)]

    def run(args):
        t0 = time.perf_counter()
        out_ = f(*args)
        out_.block_until_ready()
        return time.perf_counter() - t0, out_

    full = args_for(2 * R + 64)
    t_first, _ = run(full)  # compile + first run
    walls = [run(full)[0] for _ in range(5)]
    lo, hi = (32, 96) if R <= 1024 else (64, 192)
    a_lo, a_hi = args_for(lo), args_for(hi)
    run(a_lo)
    t_lo = statistics.median(run(a_lo)[0] for _ in range(5))
    t_hi = statistics.median(run(a_hi)[0] for _ in range(5))
    hp = np.asarray(run(full)[1])
    assert (hp <= 1).sum() > 0, "engine tagged nothing"
    mem = f.func.lower(*full, **f.keywords).compile().memory_analysis()
    tdir = os.path.join(out, f"trace_{name}")
    with jax.profiler.trace(tdir):
        run(full)
    dev = jax.devices()[0]
    res = {
        "G": G, "R": R, "S": S, "D": batch.D, "nc_cap": batch.nc_cap,
        "n_reads_window": int(n_reads),
        "first_call_s": t_first,
        "full_run_s_median": statistics.median(walls),
        "full_run_s_all": walls,
        "iters_lo_hi": [lo, hi], "t_lo_s": t_lo, "t_hi_s": t_hi,
        "per_iter_us": (t_hi - t_lo) / (hi - lo) * 1e6,
        "temp_bytes": int(getattr(mem, "temp_size_in_bytes", -1)),
        "argument_bytes": int(getattr(mem, "argument_size_in_bytes", -1)),
        "peak_bytes_in_use_cumulative": int(
            (dev.memory_stats() or {}).get("peak_bytes_in_use", -1)),
        "top_device_ops": top_device_ops(tdir),
    }
    print(f"[bench_micro] {name}: G={G} R={R} S={S} D={batch.D} "
          f"NC={batch.nc_cap} full {res['full_run_s_median'] * 1e3:.3f} ms, "
          f"{res['per_iter_us']:.3f} us/iter, temp {res['temp_bytes']} B, "
          f"peak {res['peak_bytes_in_use_cumulative']} B", flush=True)
    return res


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                  "bench_micro"))
    args = ap.parse_args()
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench_micro: no GPU; JAX's default device is "
                         f"{dev.platform}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    os.makedirs(args.out, exist_ok=True)
    res = {"device": {"platform": dev.platform, "kind": dev.device_kind,
                      "count": len(jax.devices()), "nvidia_smi": smi}}
    # smaller shape first, so the cumulative peak after it is its own
    res["loop"] = measure("loop", *loop_batch(), args.out)
    res["dense"] = measure("dense", *dense_batch(), args.out)
    with open(os.path.join(args.out, "bench_micro.json"), "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps({k: {kk: vv for kk, vv in v.items()
                          if kk != "top_device_ops"}
                      for k, v in res.items()}))


if __name__ == "__main__":
    main()
