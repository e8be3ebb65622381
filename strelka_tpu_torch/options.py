"""Engine options as frozen dataclasses.

Reference analog: the three-level config system described in SURVEY.md §5
(blt_common/blt_shared.hh, starling_common/starling_base_shared.hh,
applications/starling/starling_shared.hh, strelka_option_parser.cpp).
Defaults mirror the reference's compiled-in values plus the flags the
workflow layer always passes (strelkaGermlineWorkflow.py:94-100).
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class BaseOptions:
    """reference: blt_common/blt_shared.hh blt_options"""
    bsnp_diploid_theta: float = 0.001          # blt_shared.hh:82
    min_qscore: int = 17                       # blt_shared.hh min_qscore default
    min_mapping_quality: int = 20              # workflow --min-mapping-quality default (minMapq ini)
    het_variant_frequency_extension: float = 0.0   # blt_shared.hh:91 (RNA mode: 0.45)
    # RNA mode keeps the input soft-clipped alignment when it scores
    # at least as well as the best unclipped candidate
    # (starling_base_shared.hh:262 isRetainOptimalSoftClipping)
    retain_optimal_soft_clipping: bool = False
    max_het_variant_frequency_increment: float = 0.0501  # blt_shared.hh:105
    max_win_mismatch: int = 2                  # MMDF: max mismatches
    max_win_mismatch_flank_size: int = 20      # in +/-20bp window (methods.tex:481)
    # VCF audit metadata (##cmdline / ##reference header lines,
    # vcf_util.cpp write_vcf_audit_info analog); set by the CLIs
    cmdline: str | None = None
    reference_path: str | None = None
    # --report-evs-features: append ;EVSF=<scoring feature vector> to
    # variant records for offline EVS training (isReportEVSFeatures)
    is_report_evs_features: bool = False
    is_ignore_anom_proper_pair: bool = True
    # dependent basecall-error adjustment (adjust_joint_eprob); blt
    # default off (blt_shared.hh:83-84), the germline caller turns it
    # on (starling_shared.hh:34-35 / GermlineOptions below)
    bsnp_ssd_no_mismatch: float = 0.0
    bsnp_ssd_one_mismatch: float = 0.0


@dataclass
class StarlingBaseOptions(BaseOptions):
    """reference: starling_common/starling_base_shared.hh"""
    bindel_diploid_theta: float = 0.0001       # :95
    default_min_read_bp_flank: int = 5         # :108
    max_indel_size: int = 49                   # :124 / configure ini maxIndelSize
    indel_candidate_signal_test_alpha: float = 1e-9  # :137
    max_read_indel_toggle: int = 5             # :139
    max_candidate_indel_density: float = 0.15  # :145 (per base)
    max_candidate_indel_depth_factor: float = 3.0  # :154
    min_candidate_indel_open_length: int = 20  # :157
    max_realignment_candidates: int = 5000     # :160
    random_base_match_prob: float = 0.25       # :177
    min_het_vf: float = 0.01                   # :188
    is_remap_input_softclip: bool = False
    min_vexp: float = 0.25
    # sample-contig-tier2 options (Tier2Options.hh)
    tier2_min_mapping_quality: int = 0


@dataclass
class GermlineOptions(StarlingBaseOptions):
    """reference: applications/starling/starling_shared.hh +
    flags set by strelkaGermlineWorkflow.py:94-100."""
    # dependent basecall-error adjustment is ON for germline calling
    # (starling_shared.hh:34-35)
    bsnp_ssd_no_mismatch: float = 0.35
    bsnp_ssd_one_mismatch: float = 0.6
    gvcf_min_gqx: float = 15.0
    gvcf_min_homref_gqx: float = 15.0
    gvcf_max_snv_strand_bias: float = 10.0
    is_compute_somatic: bool = False
    enable_read_backed_phasing: bool = True
    # gvcf block compression (gvcf_options in gvcf_locus_info.hh)
    block_abs_tol: int = 3
    block_frac_tol: float = 0.3
    block_label: str = "BLOCKAVG_min30p3a"
    gvcf_block_max_nonref: float = 0.2
    # high depth filter
    max_depth_factor: float = 3.0
    is_depth_filter: bool = False
    # LowDepth: minPassedCallDepth for gVCF loci (gvcf_options.hh:68)
    gvcf_min_passed_call_depth: int = 3
    # HighSNVHPOL / HighREFREP hard filters — disabled unless >= 0
    # (starling_option_parser.cpp:136 is_max_snv_hpol = max_snv_hpol>=0)
    gvcf_max_snv_hpol: int | None = None
    gvcf_max_ref_rep: int | None = None
    # EVS
    snv_scoring_model_file: str | None = None
    indel_scoring_model_file: str | None = None
    # ploidy
    is_haploid: bool = False
    call_continuous_vf: bool = False
    # continuous caller (starling_base_shared.hh:192-195)
    continuous_frequency_expected_observation_quality: int = 17
    continuous_frequency_max_qscore: int = 40


@dataclass
class SomaticOptions(StarlingBaseOptions):
    """reference: applications/strelka/strelka_shared.hh, with the
    workflow-effective values from configureStrelkaSomaticWorkflow.py.ini
    (ssnvPrior=1e-4, ssnvNoise=5e-10, ssnvNoiseStrandBiasFrac=0,
    sindelNoiseFactor=2.2) which override the compiled defaults."""
    # the somatic app relaxes the tier1 mismatch density filter to 3
    # (strelka_shared.hh:70; germline starling keeps 2), disables
    # low-basecall-quality filtering (minBasecallErrorPhredProb=0) and
    # uses randomBaseMatchProb=0.5 for noisy-read mapping integration
    max_win_mismatch: int = 3
    min_qscore: int = 0
    random_base_match_prob: float = 0.5
    somatic_snv_rate: float = 0.0001           # ini ssnvPrior
    shared_site_error_rate: float = 5e-10      # ini ssnvNoise
    shared_site_error_strand_bias_fraction: float = 0.0  # ini
    site_somatic_normal_noise_rate: float = 0.0005
    somatic_indel_rate: float = 0.000001       # ini sindelPrior
    shared_indel_error_factor: float = 2.2     # ini sindelNoiseFactor
    indel_somatic_normal_noise_rate: float = 0.0001
    normal_sample_min_read_bp_flank: int = 1
    # ini depthFilterMultiple (HighDepth threshold vs normal chrom depth)
    max_depth_factor: float = 3.0
    somatic_snv_max_filtered_basecall_frac: float = 0.4
    somatic_snv_max_spanning_deletion_frac: float = 0.75
    somatic_snv_min_qss_ref: int = 15
    somatic_indel_max_depth_factor: float = 3.0
    somatic_indel_max_ref_repeat: int = 8
    somatic_indel_max_int_hpol_length: int = 14
    somatic_indel_max_window_filtered_basecall_frac: float = 0.3
    somatic_indel_min_qsi_ref: int = 30
    # tier2 relaxations (Tier2Options.hh)
    tier2_min_single_align_score: int = 0
    tier2_mismatch_density_filter_count: int = 10
    tier2_random_base_match_prob: float = 0.25  # Tier2Options.hh:49
    indel_region_flank_size: int = 50          # strelka_shared.hh:52
    min_passed_call_depth: int = 2             # strelka_shared.hh:57
    tier2_include_singleton: bool = True
    tier2_include_anomalous: bool = True
    # ini ssnvContamTolerance / indelContamTolerance
    ssnv_contam_tolerance: float = 0.15
    sindel_contam_tolerance: float = 0.15
    # ini sindelQuality_LowerBound (QSI_ref threshold)
    somatic_indel_min_qsi_filter: int = 40


# reference ini key -> option field (configureStrelka*Workflow.py.ini)
_GERMLINE_INI_MAP = {
    "maxindelsize": ("max_indel_size", int),
    "minmapq": ("min_mapping_quality", int),
}

_SOMATIC_INI_MAP = {
    "maxindelsize": ("max_indel_size", int),
    "depthfiltermultiple": ("max_depth_factor", float),
    "snvmaxfilteredbasecallfrac": ("somatic_snv_max_filtered_basecall_frac",
                                   float),
    "snvmaxspanningdeletionfrac": ("somatic_snv_max_spanning_deletion_frac",
                                   float),
    "indelmaxwindowfilteredbasecallfrac":
        ("somatic_indel_max_window_filtered_basecall_frac", float),
    "ssnvprior": ("somatic_snv_rate", float),
    "sindelprior": ("somatic_indel_rate", float),
    "ssnvnoise": ("shared_site_error_rate", float),
    "sindelnoisefactor": ("shared_indel_error_factor", float),
    "ssnvnoisestrandbiasfrac": ("shared_site_error_strand_bias_fraction",
                                float),
    "mintier1mapq": ("min_mapping_quality", int),
    "mintier2mapq": ("tier2_min_single_align_score", int),
    "ssnvquality_lowerbound": ("somatic_snv_min_qss_ref", int),
    "sindelquality_lowerbound": ("somatic_indel_min_qsi_filter", int),
    "ssnvcontamtolerance": ("ssnv_contam_tolerance", float),
    "indelcontamtolerance": ("sindel_contam_tolerance", float),
}


def apply_ini(opt, path: str):
    """Override option fields from a reference-style ini file
    (configureStrelkaGermlineWorkflow.py.ini /
    configureStrelkaSomaticWorkflow.py.ini; configureOptions.py reads
    these as configparser defaults). Unknown keys are reported; the
    ini section ([StrelkaGermline]/[StrelkaSomatic]) selects the map
    by the option type. Returns (opt, extras) where extras carries
    keys the workflow layer consumes (isWriteRealignedBam)."""
    import configparser
    import dataclasses

    cp = configparser.ConfigParser()
    with open(path) as f:
        cp.read_file(f)
    mapping = (_SOMATIC_INI_MAP if isinstance(opt, SomaticOptions)
               else _GERMLINE_INI_MAP)
    overrides = {}
    extras = {}
    for section in cp.sections():
        for key, val in cp.items(section):
            k = key.lower()
            if k in mapping:
                field_name, conv = mapping[k]
                overrides[field_name] = conv(val)
            elif k == "iswriterealignedbam":
                if val.strip() not in ("0", "", "false"):
                    extras["is_write_realigned_bam"] = True
            elif k == "extravariantcallerarguments":
                if val.strip():
                    extras["extra_arguments"] = val.strip()
            else:
                raise ValueError(f"unknown ini option: {key}")
    return dataclasses.replace(opt, **overrides), extras


@dataclass
class RunPaths:
    """Run-level file inputs (align files, reference, regions)."""
    reference_fasta: str = ""
    align_files: list[str] = field(default_factory=list)
    tumor_align_file: str = ""
    normal_align_file: str = ""
    candidate_indel_vcfs: list[str] = field(default_factory=list)
    forced_gt_vcfs: list[str] = field(default_factory=list)
    call_regions_bed: str | None = None
    nocompress_bed: str | None = None
    ploidy_vcf: str | None = None
    noise_vcfs: list[str] = field(default_factory=list)
    output_dir: str = "results"
    regions: list[str] = field(default_factory=list)
