"""mu_sweep_roofline.scop40 (%): the least time of the window's Mu
filter work (portbench/yardstick.py mu_sweep_work: the forward scores of
every pair, cells to the chains' ends) over the profiler seconds of the
Mu filter's kernels (csrc/mu_wavefront.cu)."""

from portbench.readers import roofline_pct
from portbench.yardstick import mu_sweep_work

# demangled names, e.g. "void (anonymous namespace)::mu_wavefront_kernel<"
KERNELS = r"(?<![A-Za-z0-9_])mu_(wavefront|band)_kernel<"


def read(run):
    return roofline_pct(run, KERNELS, mu_sweep_work)
