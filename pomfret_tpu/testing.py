"""Synthetic diploid methylation data generator.

Produces sorted+indexed BAMs with MM/ML/MD/HP tags and phased VCFs with PS
blocks, with known ground truth — the substitute for the reference's bundled
example (example/phased.bam is large-blob-stripped in this snapshot) and the
driver of end-to-end tests and benchmarks.

Design: the reference genome is built from {A,T,G} plus explicit CpG
dinucleotides so that EVERY C is a CpG C (MM delta encoding becomes exact and
simple for both strands). Haplotypes differ in CpG methylation state and in
SNPs (for the varhaptag path).
"""
from __future__ import annotations

import gzip
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .io.bam import BamRecord
from .io.bam_writer import BamWriter
from .io.records import make_record
from .io.basemod import revcomp


@dataclass
class SynthConfig:
    ref_len: int = 200_000
    cpg_every: int = 120          # one CpG per this many bp
    read_len: int = 20_000
    read_stagger: int = 700       # per-haplotype start offset step
    meth_qual: int = 250
    unmeth_qual: int = 5
    noise: float = 0.0            # per-site probability of flipped state
    nocall: float = 0.0           # per-site probability of mid-band qual
    frac_reverse: float = 0.3
    seed: int = 0
    chrom: str = "chr1"


class SynthRegion:
    def __init__(self, cfg: SynthConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        self.rng = rng
        # genome over {A,T,G}, then place CG dinucleotides
        base = rng.choice(list("ATG"), size=cfg.ref_len)
        self.cpg_sites: List[int] = []
        p = cfg.cpg_every // 2
        while p + 1 < cfg.ref_len - 2:
            base[p] = "C"
            base[p + 1] = "G"
            self.cpg_sites.append(p)
            p += cfg.cpg_every
        self.ref = "".join(base)
        self.cpg_arr = np.array(self.cpg_sites, dtype=np.int64)
        # methylation truth: hap0 methylated, hap1 unmethylated (all sites
        # informative; callers can mask ranges via set_uninformative)
        self.meth_state = np.zeros((2, len(self.cpg_sites)), dtype=np.int8)
        self.meth_state[0, :] = 1  # hap0 meth
        self.meth_state[1, :] = 0
        self.snps: List[Tuple[int, str, str, int]] = []  # pos0, ref, alt, hap_with_alt

    def set_uninformative(self, start: int, end: int) -> None:
        m = (self.cpg_arr >= start) & (self.cpg_arr < end)
        self.meth_state[0, m] = 0
        self.meth_state[1, m] = 0

    def add_snps(self, positions: Sequence[int], hap_with_alt: Sequence[int]) -> None:
        """SNPs at reference 'A' positions, ALT='T' (never creates CpGs)."""
        for pos, hap in zip(positions, hap_with_alt):
            assert self.ref[pos] == "A", f"SNP host base at {pos} is {self.ref[pos]}"
            self.snps.append((pos, "A", "T", hap))
        self.snps.sort()

    # ------------------------------------------------------------------
    def hap_seq(self, start: int, end: int, hap: int) -> str:
        s = list(self.ref[start:end])
        for pos, ref, alt, hap_alt in self.snps:
            if start <= pos < end and hap_alt == hap:
                s[pos - start] = alt
        return "".join(s)

    def _pick_indel_spot(self, start: int, end: int, dlen: int) -> Optional[int]:
        """A reference position p in (start+200, end-200) such that
        [p-2, p+dlen+2) contains no C or G (so CpG sites are unaffected)."""
        for _ in range(50):
            p = int(self.rng.integers(start + 200, end - 200))
            win = self.ref[p - 2 : p + dlen + 2]
            if "C" not in win and "G" not in win:
                return p
        return None

    def make_read(self, qname: str, start: int, hap: int,
                  reverse: bool, tagged: bool,
                  hp_label: Optional[int] = None,
                  softclip: int = 0, with_indel: Optional[str] = None
                  ) -> BamRecord:
        """One read of cfg.read_len from `hap` starting at `start`.

        hp_label overrides the HP tag value (1-based); None -> untagged.
        softclip prepends that many clipped 'T' bases; with_indel in
        {'I','D'} splices a small CpG-neutral indel into the middle.
        """
        cfg = self.cfg
        end = min(start + cfg.read_len, cfg.ref_len)
        seq = self.hap_seq(start, end, hap)
        L = end - start

        # optional CpG-neutral indel in the aligned portion
        cigar_mid = [("M", L)]
        ins_read_off = None      # read offset of inserted bases (post-splice)
        del_ref_off = None
        if with_indel == "I":
            p = self._pick_indel_spot(start, end, 0)
            if p is not None:
                ro = p - start
                seq = seq[:ro] + "TT" + seq[ro:]
                cigar_mid = [("M", ro), ("I", 2), ("M", L - ro)]
                ins_read_off = ro
                L += 2
        elif with_indel == "D":
            p = self._pick_indel_spot(start, end, 3)
            if p is not None:
                ro = p - start
                seq = seq[:ro] + seq[ro + 3:]
                cigar_mid = [("M", ro), ("D", 3), ("M", L - ro - 3)]
                del_ref_off = ro
                L -= 3

        if softclip:
            seq = "T" * softclip + seq
            cigar = [("S", softclip)] + cigar_mid
            L += softclip
        else:
            cigar = cigar_mid

        # read-position -> reference-position map from the CIGAR
        ref_of = np.full(L, -1, dtype=np.int64)
        rp, i = start, 0
        for op, ln in cigar:
            if op == "S" or op == "I":
                i += ln
            elif op == "M":
                ref_of[i : i + ln] = np.arange(rp, rp + ln)
                i += ln
                rp += ln
            elif op == "D":
                rp += ln

        # per-site meth state from the haplotype profile
        m = (self.cpg_arr >= start) & (self.cpg_arr + 1 < end)
        sites = self.cpg_arr[m]
        site_idx = np.flatnonzero(m)
        states = self.meth_state[hap, site_idx].astype(np.int8)
        if cfg.noise > 0:
            flip = self.rng.random(len(states)) < cfg.noise
            states = np.where(flip, 1 - states, states)
        quals = np.where(states == 1, cfg.meth_qual, cfg.unmeth_qual)
        if cfg.nocall > 0:
            nc = self.rng.random(len(states)) < cfg.nocall
            quals = np.where(nc, 128, quals)

        # MM/ML over the ORIGINAL read orientation; clips/insertions are
        # C-free, so every origin C is a CpG C (possibly trailing/unaligned).
        # A C is called when it is a CpG C whose stored position aligns to a
        # reference CpG site of this read; MM deltas count the skipped Cs.
        stored = seq
        origin = revcomp(stored) if reverse else stored
        o = np.frombuffer(origin.encode(), dtype=np.uint8)
        c_pos = np.flatnonzero(o == ord("C"))
        is_cg = np.zeros(len(c_pos), dtype=bool)
        inner = c_pos < L - 1
        is_cg[inner] = o[c_pos[inner] + 1] == ord("G")
        sp = (L - 2 - c_pos) if reverse else c_pos
        ref_c = np.where(is_cg, ref_of[np.clip(sp, 0, L - 1)], -1)
        k = np.searchsorted(sites, ref_c)
        k_ok = np.minimum(k, max(len(sites) - 1, 0))
        called = (ref_c >= 0) & (k < len(sites))
        if len(sites):
            called &= sites[k_ok] == ref_c
        called_at = np.flatnonzero(called)
        deltas = np.diff(called_at, prepend=-1) - 1
        mlvals = [int(q) for q in quals[k_ok[called_at]]] if len(sites) else []
        mm = ("C+m?," + ",".join(str(int(d)) for d in deltas) + ";"
              if len(deltas) else "C+m?;")

        # MD: walk aligned ops against the reference
        md_parts: List[str] = []
        run = 0
        rp, i = start, 0
        sq = np.frombuffer(seq.encode(), dtype=np.uint8)
        for op, ln in cigar:
            if op == "S" or op == "I":
                i += ln
            elif op == "M":
                rf = np.frombuffer(self.ref[rp: rp + ln].encode(),
                                   dtype=np.uint8)
                prev = -1
                for x in np.flatnonzero(sq[i: i + ln] != rf):
                    md_parts.append(str(run + int(x) - prev - 1))
                    md_parts.append(self.ref[rp + int(x)])
                    run = 0
                    prev = int(x)
                run += ln - prev - 1
                i += ln
                rp += ln
            elif op == "D":
                md_parts.append(str(run))
                md_parts.append("^" + self.ref[rp : rp + ln])
                run = 0
                rp += ln
        md_parts.append(str(run))
        md = "".join(md_parts)

        tags = [("MM", "Z", mm)]
        if mlvals:
            tags.append(("ML", "B:C", mlvals))
        tags.append(("MD", "Z", md))
        tags.append(("de", "f", 0.01))
        if tagged:
            tags.append(("HP", "i", (hap + 1) if hp_label is None else hp_label))
        return make_record(qname, 0, start, stored, cigar,
                           flag=16 if reverse else 0, mapq=60, tags=tags)

    def make_reads(self, tagged: bool = True,
                   hp_label_fn=None,
                   region: Optional[Tuple[int, int]] = None,
                   frac_clipped: float = 0.0,
                   frac_indel: float = 0.0) -> List[BamRecord]:
        cfg = self.cfg
        lo, hi = region if region else (0, cfg.ref_len)
        recs: List[BamRecord] = []
        k = 0
        for hap in (0, 1):
            start = lo + (cfg.read_stagger // 2) * hap
            while start + cfg.read_len <= hi:
                reverse = bool(self.rng.random() < cfg.frac_reverse)
                hp_label = hp_label_fn(start, hap) if hp_label_fn else None
                clip = 50 if self.rng.random() < frac_clipped else 0
                indel = None
                if self.rng.random() < frac_indel:
                    indel = "I" if self.rng.random() < 0.5 else "D"
                recs.append(self.make_read(f"read_{hap}_{k}", start, hap,
                                           reverse, tagged, hp_label,
                                           softclip=clip, with_indel=indel))
                k += 1
                start += cfg.read_stagger
        recs.sort(key=lambda r: r.pos)
        return recs

    def write_bam(self, path: str, recs: List[BamRecord]) -> None:
        with BamWriter(path, [self.cfg.chrom], [self.cfg.ref_len],
                       header_text="@HD\tVN:1.6\tSO:coordinate\n",
                       keep_index_info=True) as w:
            for r in recs:
                w.write(r)
        w.build_index(n_ref=1)

    def write_vcf(self, path: str, ps_of_pos, extra_format: str = "GT:PS",
                  flip_gt_in_block=None) -> None:
        """Write a phased VCF over self.snps.

        ps_of_pos(pos0) -> PS id (int) or None to leave the variant unphased.
        flip_gt_in_block(pos0) -> bool: True writes the GT with hap roles
        swapped (simulates a switch error between blocks).
        """
        lines = [
            "##fileformat=VCFv4.2",
            f"##contig=<ID={self.cfg.chrom},length={self.cfg.ref_len}>",
            '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
            '##FORMAT=<ID=PS,Number=1,Type=Integer,Description="Phase set">',
            "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tsample",
        ]
        for pos, ref, alt, hap_alt in self.snps:
            ps = ps_of_pos(pos)
            # GT convention: allele of hap0 | allele of hap1
            a0, a1 = (1, 0) if hap_alt == 0 else (0, 1)
            if flip_gt_in_block and flip_gt_in_block(pos):
                a0, a1 = a1, a0
            if ps is None:
                gt, fmt = f"{a0}/{a1}", "GT"
                lines.append(f"{self.cfg.chrom}\t{pos + 1}\t.\t{ref}\t{alt}\t60\tPASS\t.\t{fmt}\t{gt}")
            else:
                lines.append(f"{self.cfg.chrom}\t{pos + 1}\t.\t{ref}\t{alt}\t60\tPASS\t.\tGT:PS\t{a0}|{a1}:{ps}")
        data = "\n".join(lines) + "\n"
        if path.endswith(".gz"):
            with gzip.open(path, "wt") as f:
                f.write(data)
        else:
            with open(path, "w") as f:
                f.write(data)


def make_two_chrom_scenario(tmpdir: str, cfg: Optional[SynthConfig] = None):
    """Two chromosomes, each with a two-block joinable gap, in ONE BAM/VCF.

    Exercises the multi-chromosome quirks end-to-end (abs_start only set for
    the first chromosome of a VCF -> later chromosomes produce placeholder
    phase blocks that the GTF writer skips, blockjoin.c:1406-1410, 2743).
    Returns (bam, vcf, truths per chrom).
    """
    import os
    cfgs = []
    regions = []
    truths = []
    for ci, chrom in enumerate(("chr1", "chr2")):
        c = SynthConfig(**{**(cfg.__dict__ if cfg else SynthConfig().__dict__),
                           "chrom": chrom, "seed": ci})
        sr = SynthRegion(c)
        b1 = (5_000, 80_000)
        b2 = (120_000, 195_000)
        snp_pos = []
        for lo, hi in (b1, b2):
            p = lo
            while p < hi:
                for q in range(p, min(p + 200, c.ref_len)):
                    if sr.ref[q] == "A":
                        snp_pos.append(q)
                        break
                p += 2_000
        sr.add_snps(snp_pos, [i % 2 for i in range(len(snp_pos))])
        block1 = [p for p in snp_pos if b1[0] <= p < b1[1]]
        block2 = [p for p in snp_pos if b2[0] <= p < b2[1]]
        truths.append({
            "gap": (block1[-1] + 1, block2[0] + 1),
            "ps1": block1[0] + 1, "ps2": block2[0] + 1,
            "blocks": (b1, b2), "region": sr,
        })
        cfgs.append(c)
        regions.append(sr)

    # one BAM with both chromosomes
    from .io.bam_writer import BamWriter
    bam = os.path.join(tmpdir, "twochrom.bam")
    w = BamWriter(bam, [c.chrom for c in cfgs], [c.ref_len for c in cfgs],
                  header_text="@HD\tVN:1.6\tSO:coordinate\n",
                  keep_index_info=True)
    for ci, sr in enumerate(regions):
        recs = sr.make_reads(tagged=True)
        for r in recs:
            r.refID = ci
            r.qname = f"c{ci}_" + r.qname
            w.write(r)
    w.close()
    w.build_index(n_ref=2)

    # one VCF with both chromosomes
    vcf = os.path.join(tmpdir, "twochrom.vcf.gz")
    lines = [
        "##fileformat=VCFv4.2",
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tsample",
    ]
    for ci, (sr, t) in enumerate(zip(regions, truths)):
        for pos, ref, alt, hap_alt in sr.snps:
            ps = t["ps1"] if pos < t["blocks"][0][1] else t["ps2"]
            a0, a1 = (1, 0) if hap_alt == 0 else (0, 1)
            lines.append(f"{cfgs[ci].chrom}\t{pos + 1}\t.\t{ref}\t{alt}\t60\tPASS\t.\tGT:PS\t{a0}|{a1}:{ps}")
    data = "\n".join(lines) + "\n"
    with gzip.open(vcf, "wt") as f:
        f.write(data)
    return bam, vcf, truths


def make_multichrom_multigap_scenario(tmpdir: str, n_chroms: int = 2,
                                      n_blocks: int = 4,
                                      block_len: int = 60_000,
                                      gap_len: int = 30_000,
                                      read_stagger: int = 700,
                                      per_chrom=None,
                                      bam_threads: int = 1,
                                      bam_name: str = "multichrom.bam",
                                      trans_alternate: bool = False):
    """n_chroms chromosomes x (n_blocks-1) joinable gaps each, ONE BAM/VCF.

    The multi-host e2e fixture (VERDICT r1 item 6b): under round-robin gap
    assignment every process decides gaps on every chromosome, so the
    decision/tag merge interleaving is exercised at n>1 gaps per host and
    >1 chromosomes (the round-1 fixture had a single gap, leaving host 1
    idle). Returns (bam, vcf, truths per chrom).

    per_chrom: optional list of SynthConfig-kwarg dicts (one per
    chromosome) to vary coverage / CpG density / read length across
    chromosomes — the heterogeneity knob for the scale benchmark.

    trans_alternate: odd-index blocks get hap-swapped GT labels and the
    reads in their phase domain get swapped HP tags (the generalization of
    make_two_block_scenario's trans=True to many blocks) — EVERY gap's
    truth is then a trans join (simulated switch error at each gap,
    blockjoin.c:5044-5084's 'swapped' verdict path). A block's phase
    domain starts at the previous block's end, so reads starting inside a
    gap carry the next block's labels, matching the two-block fixture's
    `start >= gap[0]` rule. Truths gain "expected_decisions"."""
    import os
    if per_chrom is not None:
        n_chroms = len(per_chrom)
    margin = 5_000
    ref_len = margin * 2 + n_blocks * block_len + (n_blocks - 1) * gap_len
    regions, truths, cfgs = [], [], []
    for ci in range(n_chroms):
        kw = dict(ref_len=ref_len, chrom=f"chr{ci + 1}", seed=ci,
                  read_stagger=read_stagger)
        if per_chrom is not None:
            kw.update(per_chrom[ci])
        c = SynthConfig(**kw)
        sr = SynthRegion(c)
        blocks = []
        p = margin
        for _ in range(n_blocks):
            blocks.append((p, p + block_len))
            p += block_len + gap_len
        snp_pos = []
        for lo, hi in blocks:
            q = lo
            while q < hi:
                for r in range(q, min(q + 200, c.ref_len)):
                    if sr.ref[r] == "A":
                        snp_pos.append(r)
                        break
                q += 2_000
        sr.add_snps(snp_pos, [i % 2 for i in range(len(snp_pos))])
        block_snps = [[s for s in snp_pos if lo <= s < hi] for lo, hi in blocks]
        ps_ids = [bs[0] + 1 for bs in block_snps]
        truths.append({
            "blocks": blocks, "ps_ids": ps_ids, "region": sr,
            "gaps": [(block_snps[i][-1] + 1, ps_ids[i + 1])
                     for i in range(n_blocks - 1)],
            # with alternating flips every adjacent block pair disagrees
            "expected_decisions": [1 if trans_alternate else 0] *
                                  (n_blocks - 1),
        })
        cfgs.append(c)
        regions.append(sr)

    from .io.bam_writer import BamWriter
    bam = os.path.join(tmpdir, bam_name)
    w = BamWriter(bam, [c.chrom for c in cfgs],
                  [c.ref_len for c in cfgs],
                  header_text="@HD\tVN:1.6\tSO:coordinate\n",
                  threads=bam_threads, keep_index_info=True)
    # phase-domain boundaries for trans_alternate: domain i+1 starts at
    # block i's end (reads starting in a gap belong to the next block,
    # matching the two-block fixture's start >= gap[0] rule). All
    # chromosomes share one block layout, so one boundary list serves all.
    blocks0 = truths[0]["blocks"]
    domain_starts = [blocks0[i][1] for i in range(n_blocks - 1)] \
        if trans_alternate else None

    def _hp_label_fn(start, hap):
        import bisect
        bi = bisect.bisect_right(domain_starts, start)
        return ((1 - hap) + 1) if bi % 2 else (hap + 1)

    for ci, sr in enumerate(regions):
        recs = sr.make_reads(tagged=True,
                             hp_label_fn=_hp_label_fn if trans_alternate
                             else None)
        for r in recs:
            r.refID = ci
            r.qname = f"c{ci}_" + r.qname
            w.write(r)
    w.close()
    w.build_index(n_ref=n_chroms)

    vcf = os.path.join(tmpdir, "multichrom.vcf.gz")
    lines = [
        "##fileformat=VCFv4.2",
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tsample",
    ]
    for ci, (sr, t) in enumerate(zip(regions, truths)):
        for pos, ref, alt, hap_alt in sr.snps:
            ps = None
            flip = False
            for bi, ((lo, hi), pid) in enumerate(zip(t["blocks"],
                                                     t["ps_ids"])):
                if lo <= pos < hi:
                    ps = pid
                    flip = trans_alternate and bool(bi % 2)
                    break
            if ps is None:
                continue
            a0, a1 = (1, 0) if hap_alt == 0 else (0, 1)
            if flip:
                a0, a1 = a1, a0
            lines.append(f"{cfgs[ci].chrom}\t{pos + 1}\t.\t{ref}\t{alt}\t60"
                         f"\tPASS\t.\tGT:PS\t{a0}|{a1}:{ps}")
    with gzip.open(vcf, "wt") as f:
        f.write("\n".join(lines) + "\n")
    return bam, vcf, truths


# Per-chromosome shapes of the benchmark dataset (make_scale_dataset): total
# coverage 20-57x, CpG density 100-200 bp, 20 kb reads, hac/sup-like noise.
SCALE_CHROMS = [
    {"read_stagger": 700, "cpg_every": 100, "read_len": 20_000},
    {"read_stagger": 1000, "cpg_every": 120, "read_len": 20_000,
     "noise": 0.02, "nocall": 0.02},
    {"read_stagger": 1400, "cpg_every": 160, "read_len": 20_000},
    {"read_stagger": 2000, "cpg_every": 200, "read_len": 20_000,
     "noise": 0.03, "nocall": 0.03},
]
# ~222x: a gap window holds ~1.6k reads, the WGS-60x window size
# (~1,500 reads per +-50 kb window; BASELINE.md)
DENSE_CHROM = {"read_stagger": 180, "cpg_every": 120, "read_len": 20_000,
               "noise": 0.02}


def scale_dataset_params(scale: int = 1) -> dict:
    """Parameters of the benchmark dataset at a scale: 4 chromosomes x
    50*scale gaps (scale 1: 200 gaps, ~28k reads); scale > 1 adds the
    dense DENSE_CHROM chromosome."""
    per_chrom = list(SCALE_CHROMS)
    if scale > 1:
        per_chrom.append(DENSE_CHROM)
    return dict(n_blocks=50 * scale + 1, block_len=60_000, gap_len=30_000,
                per_chrom=per_chrom)


def make_scale_dataset(tmpdir: str, params: dict, bam_threads: int = 1):
    """Write the dataset of `params` (scale_dataset_params, or any
    make_multichrom_multigap_scenario kwargs) as scale.bam +
    multichrom.vcf.gz. Seeded: the same params give the same files.
    Returns (bam, vcf, n_gaps)."""
    bam, vcf, _ = make_multichrom_multigap_scenario(
        tmpdir, bam_threads=bam_threads, bam_name="scale.bam", **params)
    return bam, vcf, len(params["per_chrom"]) * (params["n_blocks"] - 1)


def make_multi_block_scenario(tmpdir: str, n_blocks: int = 6,
                              block_len: int = 60_000, gap_len: int = 30_000,
                              cfg: Optional[SynthConfig] = None):
    """n_blocks phase blocks separated by variant-free gaps; methylation is
    informative everywhere, so every gap should join cis.
    Returns (bam_path, vcf_path, truth dict with gaps list)."""
    import os
    margin = 5_000
    ref_len = margin * 2 + n_blocks * block_len + (n_blocks - 1) * gap_len
    cfg = cfg or SynthConfig(ref_len=ref_len)
    cfg.ref_len = ref_len
    sr = SynthRegion(cfg)
    blocks = []
    p = margin
    for _ in range(n_blocks):
        blocks.append((p, p + block_len))
        p += block_len + gap_len
    snp_pos = []
    for lo, hi in blocks:
        q = lo
        while q < hi:
            for r in range(q, min(q + 200, cfg.ref_len)):
                if sr.ref[r] == "A":
                    snp_pos.append(r)
                    break
            q += 2_000
    sr.add_snps(snp_pos, [i % 2 for i in range(len(snp_pos))])

    block_snps = [[s for s in snp_pos if lo <= s < hi] for lo, hi in blocks]
    ps_ids = [bs[0] + 1 for bs in block_snps]

    def ps_of_pos(pos):
        for (lo, hi), ps in zip(blocks, ps_ids):
            if lo <= pos < hi:
                return ps
        return None

    recs = sr.make_reads(tagged=True)
    bam = os.path.join(tmpdir, "multi.bam")
    vcf = os.path.join(tmpdir, "multi.vcf.gz")
    sr.write_bam(bam, recs)
    sr.write_vcf(vcf, ps_of_pos)
    gaps = [(block_snps[i][-1] + 1, ps_ids[i + 1]) for i in range(n_blocks - 1)]
    truth = {"gaps": gaps, "ps_ids": ps_ids, "blocks": blocks, "region": sr,
             "n_reads": len(recs)}
    return bam, vcf, truth


def make_two_block_scenario(tmpdir: str, trans: bool = False,
                            tagged: bool = True,
                            cfg: Optional[SynthConfig] = None,
                            uninformative: Optional[Tuple[int, int]] = None,
                            frac_clipped: float = 0.0,
                            frac_indel: float = 0.0):
    """Standard fixture: two phase blocks separated by a variant-free gap.

    Block1 variants in [5k, 80k), gap (no SNPs) in [80k, 120k), block2 in
    [120k, 195k). CpG methylation is informative everywhere, so the joiner
    should bridge the gap. With trans=True, block2's GT/HP labels are swapped
    (simulated switch error) -> expected decision 'trans'.
    Returns (bam_path, vcf_path, region, truth dict).
    """
    import os
    cfg = cfg or SynthConfig()
    sr = SynthRegion(cfg)
    if uninformative is not None:
        # wipe haplotype-specific methylation in this range (both haps
        # unmethylated) -> no usable methmer sites -> the joiner must bail
        sr.set_uninformative(*uninformative)
    b1 = (5_000, 80_000)
    gap = (80_000, 120_000)
    b2 = (120_000, 195_000)
    # SNPs on 'A' bases every ~2kb inside blocks
    snp_pos = []
    for lo, hi in (b1, b2):
        p = lo
        while p < hi:
            for q in range(p, min(p + 200, cfg.ref_len)):
                if sr.ref[q] == "A":
                    snp_pos.append(q)
                    break
            p += 2_000
    hap_with_alt = [i % 2 for i in range(len(snp_pos))]
    sr.add_snps(snp_pos, hap_with_alt)

    block1_snps = [p for p in snp_pos if b1[0] <= p < b1[1]]
    block2_snps = [p for p in snp_pos if b2[0] <= p < b2[1]]
    ps1 = block1_snps[0] + 1
    ps2 = block2_snps[0] + 1

    def ps_of_pos(pos):
        if b1[0] <= pos < b1[1]:
            return ps1
        if b2[0] <= pos < b2[1]:
            return ps2
        return None

    def flip(pos):
        return trans and pos >= b2[0]

    def hp_label_fn(start, hap):
        # reads are HP-tagged consistently with the VCF phase of their block;
        # for the trans scenario every read right of block1 (i.e. in block2's
        # phase domain, incl. right-boundary reads spanning the gap end) gets
        # swapped labels
        if trans and start >= gap[0]:
            return (1 - hap) + 1
        return hap + 1

    recs = sr.make_reads(tagged=tagged,
                         hp_label_fn=hp_label_fn if tagged else None,
                         frac_clipped=frac_clipped, frac_indel=frac_indel)
    bam = os.path.join(tmpdir, "synth.bam")
    vcf = os.path.join(tmpdir, "synth.vcf.gz")
    sr.write_bam(bam, recs)
    sr.write_vcf(vcf, ps_of_pos, flip_gt_in_block=flip)
    truth = {
        "gap": (block1_snps[-1] + 1, ps2),  # (last var of block1, PS of block2), 1-based
        "ps1": ps1, "ps2": ps2,
        "expected_decision": 1 if trans else 0,
        "region": sr,
        "blocks": (b1, b2),
    }
    return bam, vcf, truth
