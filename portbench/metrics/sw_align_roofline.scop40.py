"""sw_align_roofline.scop40 (%): the least time of the window's SW
with traceback (portbench/yardstick.py sw_align_work: every pair, as
under --verysensitive, cells to the chains' ends) over the profiler
seconds of the traceback kernels of csrc/sw_align.cu (the shared-memory
kernel and the band kernel with SCORE false, and the band kernel's
column words)."""

from portbench.readers import roofline_pct
from portbench.yardstick import sw_align_work

# demangled names, e.g. "void (anonymous namespace)::sw_align_kernel<4, 8,
# false>"; the lookbehind keeps the Mu filter's mu_band_kernel out
KERNELS = (r"(?<![A-Za-z0-9_])(sw_align_kernel|band_kernel)<\d+, ?\d+, ?false>"
           r"|(?<![A-Za-z0-9_])column_words_kernel")


def read(run):
    return roofline_pct(run, KERNELS, sw_align_work)
