"""On-card smoke test of pomfret-tpu's main path, in one process.

    python chip_smoke.py              # one GPU: phases a-e
    python chip_smoke.py --chips 4    # four GPUs: phase f only

Phases:
  a. device: a GPU must be JAX's default device (exit non-zero otherwise);
     prints nvidia-smi's name and power limit, device_kind, JAX version.
  b. data: generates, from fixed seeds, the benchmark's scale-1 dataset
     (200 gaps, 4 chromosomes, 20 kb reads, 20-57x) and a dense dataset
     whose gap windows hold ~1.6k reads (the WGS-60x window size).
  c. methphase: the CLI with --engine auto on both datasets, cold then
     warm; the device engine must be chosen and must dispatch on the GPU.
  d. report: the CLI on the scale-1 data at a chunk stride that yields
     probe windows; windows must be scored on the GPU.
  e. oracle: decisions and per-read tags of >=16 gaps (dense ones
     included) from the device run must equal the host oracle's exactly.
  f. (--chips 4) methphase on scale-1 over a 4-device mesh and on one
     device; the mesh must shard over 4 devices and the .mp.vcf/.mp.gtf
     must be byte-identical.

The last line of stdout is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failed phase raises, so the exit code is non-zero and that line is
never printed. Outputs go under --out (default chiprun_out/chip_smoke);
the generated datasets are removed after a passing run.
"""
import argparse
import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PLATFORM = "gpu"      # where every engine result must live
DENSE_R_MIN = 1536    # the dense windows' R bucket must reach this (D=8)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------- a. device
def phase_device(n_chips: int):
    import jax
    devs = jax.devices()
    if devs[0].platform != PLATFORM:
        raise SystemExit(f"chip_smoke: no GPU; JAX's default device is "
                         f"{devs[0].platform}")
    if len(devs) < n_chips:
        raise SystemExit(f"chip_smoke: --chips {n_chips} needs {n_chips} "
                         f"GPUs; JAX has {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    for line in smi.strip().splitlines():
        log(line.strip())
    log(f"[a] device_kind={devs[0].device_kind} count={len(devs)} "
        f"jax={jax.__version__}")
    return devs


# ------------------------------------------------------------------ b. data
def dataset_params():
    from pomfret_tpu.testing import DENSE_CHROM, scale_dataset_params
    return {"scale1": scale_dataset_params(1),
            "dense": dict(n_blocks=4, block_len=60_000, gap_len=30_000,
                          per_chrom=[DENSE_CHROM])}


def phase_data(out: str, names):
    from pomfret_tpu.io import native
    from pomfret_tpu.testing import make_scale_dataset
    t0 = time.perf_counter()
    log(f"[b] native IO lib available: {native.native_available()} "
        f"({time.perf_counter() - t0:.3f} s incl. build)")
    sets = {}
    params_of = dataset_params()
    for name in names:
        params = params_of[name]
        d = os.path.join(out, "data", name)
        os.makedirs(d, exist_ok=True)
        t0 = time.perf_counter()
        bam, vcf, n_gaps = make_scale_dataset(
            d, params, bam_threads=min(8, os.cpu_count() or 1))
        log(f"[b] {name}: {n_gaps} gaps generated in "
            f"{time.perf_counter() - t0:.3f} s ({os.path.getsize(bam)} B BAM)")
        sets[name] = (bam, vcf)
    return sets


# ------------------------------------------------------------- dispatch log
class DispatchLog:
    """Wraps parallel.batch.run_gap_batch_async to record every dispatched
    batch's shape and the devices its result lives on."""

    def __init__(self):
        from pomfret_tpu.parallel import batch as pb
        self.pb = pb
        self.batches = []
        orig = pb.run_gap_batch_async

        def recorded(batch, *a, **k):
            res = orig(batch, *a, **k)
            devs = res.devices()
            self.batches.append(dict(
                shape3=batch.shape3, D=batch.D, nc_cap=batch.nc_cap,
                platforms={d.platform for d in devs},
                device_ids={d.id for d in devs}))
            return res

        pb.run_gap_batch_async = recorded

    def mark(self):
        return len(self.batches), dict(self.pb.DISPATCH_STATS)

    def since(self, mark):
        n0, st0 = mark
        st = self.pb.DISPATCH_STATS
        return (self.batches[n0:], st["n_dispatches"] - st0["n_dispatches"],
                st["window_reads"] - st0["window_reads"])


def peak_bytes(devs) -> int:
    return max(int((d.memory_stats() or {}).get("peak_bytes_in_use", 0))
               for d in devs)


def run_cli(argv) -> float:
    from pomfret_tpu.cli import main as cli_main
    t0 = time.perf_counter()
    rc = cli_main(argv)
    wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"pomfret-tpu {argv[0]} exited {rc}")
    return wall


def timed_methphase(dlog, bam, vcf, prefix):
    from pomfret_tpu.utils.stats import reset_stages, stage_report
    mark = dlog.mark()
    reset_stages()
    wall = run_cli(["methphase", "-o", prefix, "--engine", "auto",
                    "--vcf", vcf, bam])
    log(f"    stage seconds (cumulative per thread): {stage_report(3)}")
    batches, n_disp, reads = dlog.since(mark)
    if n_disp <= 0:
        raise RuntimeError(f"{prefix}: the device engine never dispatched")
    plats = set().union(*(b["platforms"] for b in batches))
    if plats != {PLATFORM}:
        raise RuntimeError(f"{prefix}: engine results on {plats}, "
                           f"not {PLATFORM}")
    return wall, n_disp, reads, batches


def same_outputs(p1, p2):
    for ext in (".mp.gtf", ".mp.vcf"):
        with open(p1 + ext, "rb") as f1, open(p2 + ext, "rb") as f2:
            if f1.read() != f2.read():
                raise RuntimeError(f"{ext} differs: {p1} vs {p2}")


# ------------------------------------------------------------- c. methphase
def phase_methphase(sets, out, dlog, devs):
    from pomfret_tpu.pipeline import resolve_engine
    engine = resolve_engine("auto")
    log(f"[c] engine auto -> {engine}")
    if engine != "jax":
        raise RuntimeError("--engine auto did not choose the device engine")
    prefixes = {}
    for name, (bam, vcf) in sets.items():
        for run in ("cold", "warm"):
            prefix = os.path.join(out, f"mp_{name}_{run}")
            wall, n_disp, reads, batches = timed_methphase(dlog, bam, vcf,
                                                           prefix)
            shapes = sorted({(b["shape3"], b["D"], b["nc_cap"])
                             for b in batches})
            log(f"[c] methphase {name} {run}: wall {wall:.3f} s, "
                f"n_dispatches {n_disp}, window reads {reads}, "
                f"{reads / wall:.1f} reads/s, peak device bytes "
                f"{peak_bytes(devs)}, batches (G,R,S),D,NC {shapes}")
            prefixes[name, run] = prefix
            if name == "dense" and not any(
                    b["shape3"][1] >= DENSE_R_MIN and b["D"] == 8
                    for b in batches):
                raise RuntimeError(f"dense windows did not reach the "
                                   f"R>={DENSE_R_MIN}, D=8 bucket: {shapes}")
        same_outputs(prefixes[name, "cold"], prefixes[name, "warm"])
    return prefixes


# ---------------------------------------------------------------- d. report
def phase_report(sets, out, dlog):
    bam, vcf = sets["scale1"]
    prefix = os.path.join(out, "rep_scale1")
    mark = dlog.mark()
    wall = run_cli(["report", "-o", prefix, "--engine", "auto",
                    "--chunk-size", "40000", "--chunk-stride", "30000",
                    "--vcf", vcf, bam])
    batches, n_disp, reads = dlog.since(mark)
    with open(prefix + ".report.tsv") as f:
        verdicts = [line.rstrip("\n").split("\t")[-1] for line in f
                    if line.strip()]
    counts = {v: verdicts.count(v) for v in ("correct", "switch", "fail")}
    log(f"[d] report scale1: wall {wall:.3f} s, n_dispatches {n_disp}, "
        f"windows {len(verdicts)} {counts}")
    plats = set().union(*(b["platforms"] for b in batches))
    if n_disp <= 0 or not verdicts or plats != {PLATFORM}:
        raise RuntimeError(f"report scored no probe windows on {PLATFORM}")
    if counts["correct"] == 0:
        raise RuntimeError("report found no correct window")


# ---------------------------------------------------------------- e. oracle
def _host_oracle_gap(task):
    """Host oracle (core.engine_host.haplotag_region) for one gap window."""
    bam, chrom, start, end, cfg, n_cand = task
    from pomfret_tpu.core.intervals import Storage
    from pomfret_tpu.io.cram import open_alignment
    from pomfret_tpu.pipeline import haplotag_region_given_bam
    d, rs = haplotag_region_given_bam(Storage(), open_alignment(bam), chrom,
                                      start, end, cfg, n_cand, "host")
    return d, ({r.qname: r.hp for r in rs.reads} if d >= 0 else {})


def _host_worker_init():
    os.environ["JAX_PLATFORMS"] = "cpu"  # oracle workers never touch the card


def phase_oracle(sets, prefixes, per_chrom):
    import concurrent.futures as cf
    import multiprocessing as mp
    from pomfret_tpu.core.readset import MmrConfig
    from pomfret_tpu.pipeline import (CliOpt, _derive_chrom_params,
                                      estimate_read_coverage_cached)
    from pomfret_tpu.utils.manifest import load_manifest

    opt = CliOpt()  # the CLI defaults the methphase runs used
    config = MmrConfig(k=opt.k, k_span=opt.k_span, lo=opt.lo, hi=opt.hi,
                       cov_known=opt.cov,
                       cov_for_selection=opt.cov_for_selection,
                       cov_for_runtime=opt.cov_for_selection * 2,
                       readlen_threshold=opt.readlen_threshold,
                       min_mapq=opt.mapq)
    tasks, device = [], []
    for name, (bam, _vcf) in sets.items():
        done = load_manifest(prefixes[name, "warm"] + ".mp.manifest.jsonl")
        covs = estimate_read_coverage_cached(bam, opt.threads_bam)
        taken = {}
        for (ref, gi), e in sorted(done.items()):
            if taken.get(ref, 0) >= per_chrom:
                continue
            taken[ref] = taken.get(ref, 0) + 1
            cfg, n_cand = _derive_chrom_params(
                config, opt.n_candidates_per_iter, covs.get(ref, 0), ref)
            tasks.append((bam, ref, e["start"], e["end"], cfg, n_cand))
            device.append((name, ref, gi, e["decision"], e["tags"]))
    t0 = time.perf_counter()
    with cf.ProcessPoolExecutor(
            max_workers=min(len(tasks), os.cpu_count() or 1),
            mp_context=mp.get_context("spawn"),
            initializer=_host_worker_init) as ex:
        host = list(ex.map(_host_oracle_gap, tasks))
    bad = 0
    n_dense = 0
    for (name, ref, gi, d_dev, t_dev), (d_host, t_host), task in zip(
            device, host, tasks):
        n_dense += name == "dense"
        if d_dev == d_host and t_dev == t_host:
            continue
        bad += 1
        diff = sorted(q for q in set(t_dev) | set(t_host)
                      if t_dev.get(q) != t_host.get(q))
        log(f"[e] MISMATCH {name} {ref} gap {gi} [{task[2]},{task[3]}): "
            f"decision device {d_dev} host {d_host}; {len(diff)} reads' "
            f"tags differ, e.g. "
            f"{[(q, t_dev.get(q), t_host.get(q)) for q in diff[:5]]}")
    log(f"[e] oracle: {len(tasks)} gaps ({n_dense} dense), {bad} mismatches,"
        f" host oracle {time.perf_counter() - t0:.3f} s")
    if len(tasks) < 16 or n_dense == 0:
        raise RuntimeError("oracle check covered too few gaps")
    if bad:
        raise RuntimeError(f"{bad} gaps differ between the device engine and "
                           "the host oracle")


# ------------------------------------------------------------ f. four chips
def phase_mesh(sets, out, dlog, n_chips):
    bam, vcf = sets["scale1"]
    prefixes = {}
    for label, cap in ((f"mesh{n_chips}", str(n_chips)), ("single", "1")):
        os.environ["POMFRET_MESH_DEVICES"] = cap
        for run in ("cold", "warm"):
            prefix = os.path.join(out, f"mp_scale1_{label}_{run}")
            wall, n_disp, reads, batches = timed_methphase(dlog, bam, vcf,
                                                           prefix)
            n_dev = dlog.pb.DISPATCH_STATS["n_devices_last"]
            ids = set().union(*(b["device_ids"] for b in batches))
            log(f"[f] methphase scale1 {label} {run}: wall {wall:.3f} s, "
                f"n_dispatches {n_disp}, window reads {reads}, "
                f"{reads / wall:.1f} reads/s, devices {sorted(ids)}")
            prefixes[label, run] = prefix
            want = int(cap)
            if n_dev != want or any(len(b["device_ids"]) != want
                                    for b in batches):
                raise RuntimeError(f"{label}: dispatched over {n_dev} "
                                   f"devices, result shards on {ids}")
    os.environ.pop("POMFRET_MESH_DEVICES")
    for run in ("cold", "warm"):
        same_outputs(prefixes[f"mesh{n_chips}", run], prefixes["single", run])
    log(f"[f] .mp.vcf/.mp.gtf byte-identical: {n_chips} devices vs 1")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4))
    ap.add_argument("--out", default=os.path.join(HERE, "chiprun_out",
                                                  "chip_smoke"))
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    devs = phase_device(args.chips)
    sys.path.insert(0, HERE)
    os.makedirs(args.out, exist_ok=True)
    dlog = DispatchLog()
    if args.chips == 1:
        sets = phase_data(args.out, ("scale1", "dense"))
        prefixes = phase_methphase(sets, args.out, dlog, devs)
        phase_report(sets, args.out, dlog)
        phase_oracle(sets, prefixes, per_chrom=4)
    else:
        sets = phase_data(args.out, ("scale1",))
        phase_mesh(sets, args.out, dlog, args.chips)
    shutil.rmtree(os.path.join(args.out, "data"))
    log(f"[done] total {time.perf_counter() - t_start:.3f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
