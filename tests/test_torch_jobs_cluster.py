"""The port's germline fan-out through a cluster scheduler, on
tests/test_torch_jobs.py's dataset (two samples jointly, 15 kb segments)
against the JAX package's single-process run:

- --jobs 2 through a blocking --cluster-submit wrapper (one submission a
  worker, none for the merge);
- --jobs 2 through a fake non-blocking scheduler (--cluster-status) that
  loses the first worker, which is re-queued.

variants.vcf.gz, genome.S1.vcf.gz and genome.S2.vcf.gz must be
byte-identical to the JAX package's after dropping the volatile and
program-name header lines.
"""
import sys

from tests.test_torch_jobs import (_assert_matches, _germline,  # noqa: F401
                                   dataset, env, jax_outputs)


def test_cluster_submit_wraps_workers(dataset, jax_outputs, env, tmp_path):
    """--cluster-submit (pyflow sge-mode analog): every worker command
    runs through the blocking submit wrapper, the merge does not."""
    d, args = dataset
    sub = tmp_path / "submit.sh"
    log = tmp_path / "submits.log"
    sub.write_text("#!/bin/sh\necho \"$@\" >> %s\nexec \"$@\"\n" % log)
    sub.chmod(0o755)
    out = d / "cluster"
    assert _germline(args, out, "--jobs", "2",
                     "--cluster-submit", str(sub)) == 0
    lines = log.read_text().splitlines()
    assert len(lines) == 2  # one submission per worker, none for merge
    assert all("--process-index" in l and "strelka_tpu_torch" in l
               for l in lines)
    _assert_matches(jax_outputs, out)


def test_cluster_async_lost_worker_requeued(dataset, jax_outputs, env,
                                            tmp_path, capfd):
    """Non-blocking cluster mode (pyflow qsub/qstat analog): a fake
    scheduler drops the first worker 2 s in (killed before it writes its
    exit status); the poll loop finds the lost job and re-queues it."""
    d, args = dataset
    jobdir = tmp_path / "sched"
    jobdir.mkdir()
    submit = tmp_path / "fake_qsub.py"
    submit.write_text(f"""#!/usr/bin/env python3
import os, subprocess, sys, glob
jobdir = {str(jobdir)!r}
shell = sys.argv[-1]
n = len(glob.glob(os.path.join(jobdir, '*.pid'))) + 1
if n == 1 and not os.path.exists(os.path.join(jobdir, 'sabotaged')):
    open(os.path.join(jobdir, 'sabotaged'), 'w').close()
    shell = '(' + shell.split(';')[0] + ') & P=$!; sleep 2; kill -9 $P'
p = subprocess.Popen(['/bin/sh', '-c', shell], start_new_session=True)
open(os.path.join(jobdir, f'{{n}}.pid'), 'w').write(str(p.pid))
print(f'Your job {{n}} has been submitted')
""")
    status = tmp_path / "fake_qstat.py"
    status.write_text(f"""#!/usr/bin/env python3
import os, sys
jobdir = {str(jobdir)!r}
pid = int(open(os.path.join(jobdir, sys.argv[1] + '.pid')).read())
try:
    os.kill(pid, 0)
    print('running')
except ProcessLookupError:
    print('done')
    sys.exit(1)
""")
    out = d / "cluster_async"
    rc = _germline(args, out, "--jobs", "2",
                   "--cluster-submit", f"{sys.executable} {submit}",
                   "--cluster-status", f"{sys.executable} {status}",
                   "--retry-max", "2", "--retry-wait", "0.2")
    err = capfd.readouterr().err
    assert rc == 0, err[-3000:]
    assert "worker 0/2 lost by scheduler; re-queueing" in err, err[-2000:]
    assert len(list(jobdir.glob("*.pid"))) == 3
    _assert_matches(jax_outputs, out)
