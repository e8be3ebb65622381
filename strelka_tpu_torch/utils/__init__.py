from . import cigar, logsum, qscore, ranges, stats  # noqa: F401
