"""Top-level CLI dispatcher of the PyTorch/CUDA port.

Reference analog: the configureStrelka*Workflow.py entry scripts.

  python -m strelka_tpu_torch germline --reference ... --align-file ... \\
      [--align-file ...] --output-dir ... [--device cuda|cpu] [--jobs N] \\
      [--mesh auto|N|DPxSP]
  python -m strelka_tpu_torch somatic --reference ... \\
      --normal-align-file ... --tumor-align-file ... \\
      --output-dir ... [--device cuda|cpu] [--jobs N] [--mesh auto|N|DPxSP]
  python -m strelka_tpu_torch denovo --proband ... --mother ... --father ...
  python -m strelka_tpu_torch noise-extractor --reference ... --align-file ...
  python -m strelka_tpu_torch tools <tool> ...

germline and somatic take BAM or CRAM input and the fan-out options of
strelka_tpu (--jobs, --cluster-submit/--cluster-status with --retry-*,
--process-index/--process-count with --merge-only, and coordinated
processes through STRELKA_TPU_COORDINATOR/_NUM_PROCESSES/_PROCESS_ID),
and --mesh, the engine mesh that shards a process's kernel launches over
local devices; germline calls one sample or several jointly, with the
germline EVS model files, --disable-evs, --call-continuous-vf, --rna and
the sequence-error estimation pre-pass (--estimate-sequence-error, its
fits on --device). denovo (trio DQ, per-sample gVCFs or one multi-sample
VCF) and noise-extractor (a panel-of-normals site-noise VCF) are host
code. tools runs the twelve tools of strelka_tpu (no tool: the list,
exit 2); estimate-parameters takes --device cuda|cpu (default cuda).
"""
from __future__ import annotations

import sys


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd == "germline":
        from .workflow.germline import run_germline
        return run_germline(rest)
    if cmd == "somatic":
        from .workflow.somatic import run_somatic
        return run_somatic(rest)
    if cmd == "tools":
        from .workflow.tools import main as tools_main
        return tools_main(rest)
    if cmd == "denovo":
        from .workflow.denovo import run_denovo
        return run_denovo(rest)
    if cmd == "noise-extractor":
        from .workflow.noise_extractor import run_noise_extractor
        return run_noise_extractor(rest)
    print(f"unknown command: {cmd}\n{__doc__}", file=sys.stderr)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
