"""Distribution overheads of multi-process methphase, on the CPU backend.

CPU-mesh runs at 1/2/4 jax.distributed processes (the launcher
tests/test_multihost_e2e.py pins byte-identity with) measure the partition
balance (reads/gaps per proc) and the distribution overheads: all-gather
wall seconds + payload bytes (DIST_STATS), host-0 write serialization
(writers stage), and per-proc dispatch stats. These costs are
workload-determined, not device-determined, so every child process runs
on the CPU backend (JAX_PLATFORMS=cpu) and none of them opens a GPU.
Prints one JSON object; device walls are not measured here.

Usage: python tools/bench_scaling.py [rounds per N]
       (BENCH_SCALE selects the dataset, as in bench.py)
"""
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def run_n_procs(n_procs, bam, vcf, outdir, salt, round_i):
    env0 = dict(os.environ)
    env0.update({
        "PYTHONPATH": REPO,
        "JAX_PLATFORMS": "cpu",
        "POMFRET_PREFETCH": "0",
    })
    if n_procs > 1:
        env0.update({
            "POMFRET_COORDINATOR":
                "127.0.0.1:%d" % (21000 + ((os.getpid() + salt) % 20000)),
            "POMFRET_NUM_PROCS": str(n_procs),
        })
    procs = []
    stats_files = []
    t0 = time.time()
    for pid in range(n_procs):
        env = dict(env0)
        sf = os.path.join(outdir, f"stats_{n_procs}_{round_i}_{pid}.json")
        stats_files.append(sf)
        env["POMFRET_STATS_OUT"] = sf
        if n_procs > 1:
            env["POMFRET_PROC_ID"] = str(pid)
        args = ["methphase", "-o",
                os.path.join(outdir, f"out_{n_procs}_{round_i}"),
                "--engine", "jax", "--vcf", vcf, bam]
        procs.append(subprocess.Popen(
            [sys.executable, "-c",
             "import jax; jax.config.update('jax_platforms','cpu');"
             "from pomfret_tpu.cli import main; import sys;"
             f"sys.exit(main({args!r}))"],
            env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
            text=True))
    for p in procs:
        _, err = p.communicate(timeout=3000)
        assert p.returncode == 0, err[-3000:]
    wall = time.time() - t0
    stats = [json.load(open(sf)) for sf in stats_files]
    return wall, stats


def main():
    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    from bench import build_scale_dataset
    bam, vcf, n_gaps = build_scale_dataset()
    out = {"dataset_gaps": n_gaps, "rounds": rounds,
           "host_cpus": os.cpu_count(),
           "caveat": ("CPU-backend procs time-share this host's few cores;"
                      " wall efficiency is a lower bound — the work-split"
                      " columns carry the partition-balance signal")}
    results = {}
    with tempfile.TemporaryDirectory() as od:
        for n in (1, 2, 4):
            walls, all_stats = [], None
            for r in range(rounds):
                wall, stats = run_n_procs(n, bam, vcf, od, salt=37 * n, round_i=r)
                walls.append(wall)
                all_stats = stats
                print(f"[scaling] n={n} round {r}: wall {wall:.1f}s",
                      file=sys.stderr)
            reads = [s["dispatch"]["window_reads"] for s in all_stats]
            gaps = [s["dispatch"]["gaps_decided"] for s in all_stats]
            dw = [round(s["dispatch"]["device_wait_s"], 2) for s in all_stats]
            results[n] = {
                "wall_s_best": round(min(walls), 2),
                "wall_s_all": [round(w, 2) for w in walls],
                "window_reads_per_proc": reads,
                "gaps_per_proc": gaps,
                "device_wait_s_per_proc": dw,
                "proc_wall_s": [s["wall_s"] for s in all_stats],
            }
            results[n]["allgather_s_per_proc"] = [
                round(s.get("dist", {}).get("allgather_s", 0.0), 3)
                for s in all_stats]
            results[n]["allgather_bytes_per_proc"] = [
                s.get("dist", {}).get("allgather_bytes", 0)
                for s in all_stats]
            results[n]["writers_s_host0"] = all_stats[0]["stages"].get(
                "writers", 0.0)
            if len(reads) > 1 and sum(reads):
                results[n]["read_imbalance"] = round(
                    max(reads) / (sum(reads) / len(reads)), 3)
                results[n]["gap_imbalance"] = round(
                    max(gaps) / (sum(gaps) / len(gaps)), 3)
    out["by_procs"] = {str(k): v for k, v in results.items()}

    # per-proc all-gather walls include barrier skew (early procs wait in
    # the collective for stragglers that time-share this host's cores);
    # the last-arriving proc's wait (min over procs) bounds the pure
    # collective cost, and the payload-bytes model cross-checks it
    r4 = results.get(4, {})
    ag_all = r4.get("allgather_s_per_proc", [0.0])
    ag_bytes = max(r4.get("allgather_bytes_per_proc", [0]))
    out["overheads_4proc"] = {
        "allgather_s_last_arrival": round(min(ag_all), 3),
        "allgather_s_per_proc_incl_barrier_skew": [round(x, 3)
                                                   for x in ag_all],
        "allgather_bytes": int(ag_bytes),
        "allgather_s_at_1GBps_model": round(ag_bytes / 1e9, 4),
        "writers_s_host0": r4.get("writers_s_host0", 0.0),
        "read_imbalance_4proc": r4.get("read_imbalance", 1.0),
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
