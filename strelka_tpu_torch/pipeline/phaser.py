"""Read-backed phasing over active-region haplotype ids.

Faithful re-implementation of the reference's VariantPhaser
(VariantPhaser.cpp:25-264, VariantPhaser.hh:37-106): loci stream
through a buffer while inside active regions; when a locus outside all
active regions arrives the buffer is phased per sample and flushed.
Within a buffer, each sample's variant loci are segmented into runs of
equal active-region id; for each run:

  - het non-conflict variants are counted (numHetVariants); a run with
    <= 1 of them is left unphased (VariantPhaser.cpp:191-192)
  - conflict = VcfGenotype::isConflict (vcf_util.hh:282-289): a het
    whose two allele haplotype ids are equal (e.g. alt not on a
    selected haplotype -> id 0) or contain id 3; a non-het with
    differing ids
  - every het non-conflict variant gets phaseSetId = the VCF POS of the
    run's first such variant (site pos+1 / indel pos,
    VariantPhaser.cpp:199-216)
  - if the run's het variants do not cover both alt haplotypes
    (isHetHap1 and isHetHap2), genotypes are phased WITHOUT allele
    flipping ("0|1"; one haplotype is the reference,
    VariantPhaser.cpp:221-226)
  - otherwise alleles are oriented so the first variant prints "0|1":
    haplotypeIdOfFirstNonRefAllele records the haplotype OPPOSITE the
    first variant's alt (VariantPhaser.cpp:232-241), and a variant is
    flipped when its nonref allele lies on that haplotype
    (VariantPhaser.cpp:243-254)

The production entry point build_phase_plan() is a two-pass
restructuring of createPhaseRecord; tests/test_phaser.py fuzzes it
against a literal control-flow transcription of the C++.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class SampleGt:
    """One sample's genotype view of a locus (VcfGenotype subset)."""
    ploidy: int
    a0: int            # allele indices, unphased order (a0 <= a1)
    a1: int
    hap0: int          # haplotype id per allele (0 when ref / unknown)
    hap1: int
    is_variant: bool

    def is_het(self) -> bool:
        return self.ploidy == 2 and self.a0 != self.a1

    def is_conflict(self) -> bool:
        # vcf_util.hh:282-289
        if self.is_het():
            return (self.hap0 == self.hap1 or self.hap0 == 3
                    or self.hap1 == 3)
        return self.hap0 != self.hap1


@dataclass
class PhaseLocus:
    """One locus in emission order."""
    key: object                      # caller's plan-lookup identity
    vcf_pos: int                     # printed VCF POS (PS value source)
    ar_id: int                       # active-region id; -1 outside ARs
    samples: list                    # [SampleGt | None] per sample


@dataclass
class PhaseDecision:
    ps: int
    phased: bool = False   # emit '|' genotype
    flip: bool = False     # swap a0/a1 in the emitted genotype


def build_phase_plan(loci: list[PhaseLocus], n_samples: int,
                     ) -> dict[tuple[object, int], PhaseDecision]:
    """Phase an ordered locus stream; returns {(locus.key, sample):
    PhaseDecision} for every (variant, sample) that gets a phase set.

    Buffer semantics: a locus with ar_id < 0 flushes the buffer and
    passes through unphased (VariantPhaser.cpp:36-48). The quirk that
    haplotypeIdOfFirstNonRefAllele is initialized once per BUFFER and
    persists across ar-id runs within it (VariantPhaser.cpp:163,
    flagged as a corner-case risk by the reference's own TODO comment
    :167-174) is reproduced faithfully.
    """
    plan: dict[tuple[object, int], PhaseDecision] = {}
    buffers: list[list[PhaseLocus]] = [[]]
    for locus in loci:
        if locus.ar_id < 0:
            if buffers[-1]:
                buffers.append([])
        else:
            buffers[-1].append(locus)
    for buf in buffers:
        if buf:
            _phase_buffer(buf, n_samples, plan)
    return plan


def _phase_buffer(buf: list[PhaseLocus], n_samples: int,
                  plan: dict) -> None:
    """createPhaseRecord over one flushed buffer, per sample."""
    for s in range(n_samples):
        # pass 1: per ar-id run, count het non-conflict variants and
        # which alt haplotypes they touch (VariantPhaser.cpp:107-152)
        runs: list[dict] = []
        cur_ar = -1
        for locus in buf:
            sg = locus.samples[s]
            if sg is None or not sg.is_variant or locus.ar_id < 0:
                continue
            if locus.ar_id != cur_ar:
                runs.append({"n_het": 0, "hap1": False, "hap2": False})
                cur_ar = locus.ar_id
            if sg.is_het() and not sg.is_conflict():
                run = runs[-1]
                run["n_het"] += 1
                for h in (sg.hap0,) + ((sg.hap1,) if sg.ploidy == 2
                                       else ()):
                    if h == 1:
                        run["hap1"] = True
                    elif h == 2:
                        run["hap2"] = True

        # pass 2: assign phase sets + orientation
        # (VariantPhaser.cpp:154-257)
        run_idx = -1
        cur_ar = -1
        first_nonref_hap = 0   # per buffer+sample, NOT per run
        pos_first = -1
        for locus in buf:
            sg = locus.samples[s]
            if sg is None or not sg.is_variant or locus.ar_id < 0:
                continue
            if locus.ar_id != cur_ar:
                run_idx += 1
                pos_first = -1
                cur_ar = locus.ar_id
            run = runs[run_idx]
            if run["n_het"] <= 1:
                continue
            if (not sg.is_het()) or sg.is_conflict():
                continue
            if pos_first < 0:
                pos_first = locus.vcf_pos
            dec = PhaseDecision(ps=pos_first)
            if not (run["hap1"] and run["hap2"]):
                # one haplotype is the reference: phased, no flip
                dec.phased = True
            else:
                if first_nonref_hap == 0:
                    if sg.hap0 > 0:
                        first_nonref_hap = sg.hap0
                    elif sg.hap1 == 1:
                        first_nonref_hap = 2
                    elif sg.hap1 == 2:
                        first_nonref_hap = 1
                dec.phased = True
                if sg.hap0 == 0:
                    dec.flip = sg.hap1 == first_nonref_hap
                else:
                    dec.flip = sg.hap0 != first_nonref_hap
            plan[(locus.key, s)] = dec
