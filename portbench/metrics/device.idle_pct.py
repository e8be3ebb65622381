"""device.idle_pct: the share of the traced window in which no device
operation ran: 1 - the union of the device events' intervals
(torch.profiler, CUDA activity; the benchmark's own stream left out)
over the traced window, in percent."""


def read(run):
    busy = run.get("busy_s")
    traced = run["window_s"]
    if busy is None or busy <= 0 or traced <= 0:
        return None
    return 100.0 * (1.0 - busy / traced)
