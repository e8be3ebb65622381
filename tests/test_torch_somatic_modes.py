"""The port's somatic CLI against the JAX package's on
tests/test_torch_somatic_e2e.py's dryrun T/N dataset, with
--report-evs-features and on a --region with the callable-regions BED
and the realigned BAMs (--disable-evs and the scoring model files are
tests/test_torch_somatic_models.py's).

somatic.snvs.vcf.gz and somatic.indels.vcf.gz must be byte-identical
after dropping the volatile and program-name header lines.
"""
import pytest

from tests.test_torch_somatic_e2e import (check_mode,  # noqa: F401
                                          dataset, no_default_evs_model)


@pytest.mark.parametrize("mode,extra", [
    pytest.param("evsf", ["--exome", "--report-evs-features"],
                 id="evsf-extra2"),
    pytest.param("region", ["--exome", "--region", "syn:10001-40000",
                            "--output-callable-regions",
                            "--output-realigned-bam"], id="region-extra4")])
def test_outputs_byte_identical_to_jax(dataset, mode, extra):
    check_mode(dataset, mode, extra)
