from . import bam, bed, bgzf, fasta, vcf  # noqa: F401
