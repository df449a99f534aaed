"""device_idle_pct.scop40 (%): 100 x (1 - busy / window) of the traced
window, busy the union of the kernel, copy and set intervals of the
profiler's trace within the benchmark's spans."""

from portbench.readers import idle_pct


def read(run):
    return idle_pct(run)
