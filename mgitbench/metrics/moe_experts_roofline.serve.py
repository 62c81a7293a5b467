"""The dropless MoE's grouped products' share of their roofline: the
calls' least seconds on an H100 over the device seconds of the grouped
GEMM kernel's launches in the trace.

A call of ``grouped_mm(rows, weights, offsets)`` computes the rows up to
``offsets[-1]``, each through the weights of its group. Its least seconds
are the larger of its operations (2 x rows x K x N) at the dtype's peak
and its bytes at 3.35 TB/s: those rows read and their results written
once, and the weights of the groups that received rows read once. Rows
past the last offset and experts without rows count nothing, so no
reading can exceed 100%. The offsets stay on the card during the window:
a call's bound holds them and reads them to the host when the metric is
read, after the window, so the probe makes the traced run wait on the
card nowhere."""

from mgitbench import formulas
from mgitbench.devtrace import dtype_name, roofline_percent


class Bound:
    """One call's least seconds, read from its offsets when first asked
    for (``float``); sums with numbers and other bounds as a float."""

    def __init__(self, rows, weights, offsets):
        _, self.K, self.N = weights.shape
        self.dtype = dtype_name(rows)
        self.offsets = offsets
        self.seconds = None

    def __float__(self):
        if self.seconds is None:
            ends = self.offsets.tolist()
            R = ends[-1] if ends else 0
            used = sum(1 for a, b in zip([0] + ends[:-1], ends) if b > a)
            K, N = self.K, self.N
            item = formulas.ITEMSIZE[self.dtype]
            ops_s = 2 * R * K * N / formulas.PEAK_OPS_PER_S[self.dtype]
            bytes_s = ((R * (K + N) + used * K * N) * item
                       / formulas.HBM_BYTES_PER_S)
            self.seconds, self.offsets = max(ops_s, bytes_s), None
        return self.seconds

    def __add__(self, other):
        return float(self) + float(other)

    __radd__ = __add__


def bound_s(rows, weights, offsets):
    return Bound(rows, weights, offsets)


# the entry point, the device kernel's name, the least seconds of a call
PROBE = ("repro_torch.models.layers", "grouped_mm", "GroupProblemShape",
         bound_s)


def read(run):
    return roofline_percent(run, PROBE)
