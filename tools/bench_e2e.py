"""End-to-end methphase benchmark on a large synthetic scenario.

Generates (once, cached under .bench_data/) a multi-block diploid scenario
(default 20 blocks / 19 joinable gaps over ~1.8 Mb, ~2.5k reads), then runs
the FULL pipeline (load gaps -> window loads -> device engine -> decisions
-> writers) and reports wall time and end-to-end reads/s.

    python tools/bench_e2e.py [--engine jax|host] [--blocks N] [--profile]
"""
import argparse
import cProfile
import io
import os
import pstats
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _cache_dir(n_blocks: int) -> str:
    return os.path.join(REPO, ".bench_data", f"e2e_b{n_blocks}")


def build(n_blocks: int):
    cache = _cache_dir(n_blocks)
    bam = os.path.join(cache, "multi.bam")
    vcf = os.path.join(cache, "multi.vcf.gz")
    if os.path.exists(bam) and os.path.exists(vcf):
        return bam, vcf
    os.makedirs(cache, exist_ok=True)
    t0 = time.time()
    from pomfret_tpu.testing import make_multi_block_scenario
    bam, vcf, truth = make_multi_block_scenario(cache, n_blocks=n_blocks)
    print(f"[e2e] generated {n_blocks} blocks, {truth['n_reads']} reads "
          f"in {time.time()-t0:.1f}s", file=sys.stderr)
    return bam, vcf


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--engine", default="jax")
    ap.add_argument("--blocks", type=int, default=20)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()

    bam, vcf = build(args.blocks)
    out = os.path.join(_cache_dir(args.blocks), "out")

    from pomfret_tpu.cli import main as cli_main
    argv = ["methphase", "-o", out, "-c", "50", "--vcf", vcf,
            "--engine", args.engine, bam]

    import jax  # warm the backend + count reads once outside the timing
    from pomfret_tpu.io.bam import BamReader
    n_reads = sum(1 for _ in BamReader(bam).fetch_all())
    print(f"[e2e] backend={jax.default_backend()} n_reads={n_reads}",
          file=sys.stderr)

    t0 = time.time()
    if args.profile:
        pr = cProfile.Profile()
        pr.enable()
        ret = cli_main(argv)
        pr.disable()
        s = io.StringIO()
        pstats.Stats(pr, stream=s).sort_stats("cumulative").print_stats(35)
        print(s.getvalue(), file=sys.stderr)
    else:
        ret = cli_main(argv)
    dt = time.time() - t0
    assert ret == 0

    joins = sum(1 for ln in open(out + ".mp.gtf"))
    print(f"[e2e] engine={args.engine} blocks={args.blocks}: {dt:.1f}s wall, "
          f"{n_reads/dt:.0f} input reads/s, gtf blocks={joins}",
          file=sys.stderr)


if __name__ == "__main__":
    main()
