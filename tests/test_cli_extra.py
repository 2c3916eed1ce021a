"""CLI coverage beyond the main E2E flows: report, jax engine, gtf/tsv
inputs, coverage estimation."""
import os

import pytest

from pomfret_tpu.cli import main as cli_main
from pomfret_tpu.testing import make_two_block_scenario


def test_report_subcommand(tmp_path):
    d = str(tmp_path)
    bam, vcf, truth = make_two_block_scenario(d, trans=False)
    prefix = os.path.join(d, "rep")
    rc = cli_main(["report", "-o", prefix, "-c", "50",
                   "--chunk-size", "40000", "--chunk-stride", "30000",
                   "--vcf", vcf, bam])
    assert rc == 0
    rows = [l.split("\t") for l in open(prefix + ".report.tsv").read().strip().split("\n")]
    assert len(rows) >= 2
    outcomes = {r[3] for r in rows}
    assert "correct" in outcomes  # interior windows must rejoin correctly
    assert "switch" not in outcomes


def test_methphase_jax_engine(tmp_path):
    d = str(tmp_path)
    bam, vcf, truth = make_two_block_scenario(d, trans=False)
    prefix = os.path.join(d, "out")
    rc = cli_main(["methphase", "-o", prefix, "-c", "50", "--vcf", vcf,
                   "--engine", "jax", bam])
    assert rc == 0
    gtf = open(prefix + ".mp.gtf").read()
    assert len(gtf.strip().split("\n")) == 1  # joined
    assert str(truth["ps1"]) in gtf


def test_methphase_gtf_input(tmp_path):
    d = str(tmp_path)
    bam, vcf, truth = make_two_block_scenario(d, trans=False)
    # derive a GTF of phase blocks from the truth
    sr = truth["region"]
    b1, b2 = truth["blocks"]
    block1 = [p for (p, *_ ) in sr.snps if b1[0] <= p < b1[1]]
    block2 = [p for (p, *_ ) in sr.snps if b2[0] <= p < b2[1]]
    gtf_in = os.path.join(d, "blocks.gtf")
    with open(gtf_in, "w") as f:
        for blk in (block1, block2):
            s, e = blk[0] + 1, blk[-1] + 1
            f.write(f'chr1\tPhasing\texon\t{s}\t{e}\t.\t+\t.\tgene_id "{s}"; transcript_id "{s}.1"\n')
    prefix = os.path.join(d, "out")
    rc = cli_main(["methphase", "-o", prefix, "-c", "50", "--gtf", gtf_in, bam])
    assert rc == 0
    out = open(prefix + ".mp.gtf").read().strip().split("\n")
    assert len(out) == 1  # joined into one block


def test_methphase_coverage_estimation(tmp_path):
    """No -c: coverage must be estimated from the BAM."""
    d = str(tmp_path)
    bam, vcf, truth = make_two_block_scenario(d, trans=False)
    prefix = os.path.join(d, "out")
    rc = cli_main(["methphase", "-o", prefix, "--vcf", vcf, bam])
    assert rc == 0
    assert len(open(prefix + ".mp.gtf").read().strip().split("\n")) == 1


def test_report_jax_engine_matches_host(tmp_path):
    """report --engine jax rides the batched gap engine (the reference
    scores windows serially, blockjoin.c:5053-5058); the TSV must match
    the host engine byte-for-byte."""
    d = str(tmp_path)
    bam, vcf, truth = make_two_block_scenario(d, trans=False)
    p_h = os.path.join(d, "rep_h")
    p_j = os.path.join(d, "rep_j")
    args = ["report", "-c", "50", "--chunk-size", "40000",
            "--chunk-stride", "30000", "--vcf", vcf]
    assert cli_main(args[:1] + ["-o", p_h, "--engine", "host"] + args[1:] + [bam]) == 0
    assert cli_main(args[:1] + ["-o", p_j, "--engine", "jax"] + args[1:] + [bam]) == 0
    with open(p_h + ".report.tsv") as f1, open(p_j + ".report.tsv") as f2:
        assert f1.read() == f2.read()


def test_methphase_untagged_jax_matches_host(tmp_path):
    """-u (varhaptag pre-tagging) + jax engine: outputs must match host."""
    d = str(tmp_path)
    bam, vcf, truth = make_two_block_scenario(d, trans=False, tagged=False)
    p_h = os.path.join(d, "uh")
    p_j = os.path.join(d, "uj")
    base = ["methphase", "-c", "50", "-u", "--vcf", vcf]
    assert cli_main(base[:1] + ["-o", p_h, "--engine", "host"] + base[1:] + [bam]) == 0
    assert cli_main(base[:1] + ["-o", p_j, "--engine", "jax"] + base[1:] + [bam]) == 0
    for ext in (".mp.gtf", ".mp.vcf"):
        assert open(p_h + ext).read() == open(p_j + ext).read(), ext


def test_warmup_subcommand(tmp_path, monkeypatch):
    """warmup pre-compiles the engine programs real runs will request; on
    the CPU backend it must exercise the full load+pack+dispatch path when
    the engine is forced to jax (the vmapped XLA engine compiles)."""
    from pomfret_tpu.testing import make_two_block_scenario
    bam, vcf, truth = make_two_block_scenario(str(tmp_path))
    prefix = str(tmp_path / "wu")
    # host/auto on CPU: explicit no-op
    rc = cli_main(["warmup", "-o", prefix, "-c", "50", "--vcf", vcf, bam])
    assert rc == 0
    # forced jax engine: compiles the real program at max_iters=0
    rc = cli_main(["warmup", "-o", prefix, "-c", "50", "--engine", "jax",
                   "--vcf", vcf, bam])
    assert rc == 0
