"""The commit quantize kernel's share of its byte bound (f32 p1 and p2
read, int8 q written, at 3.35 TB/s) over its device seconds in the
trace."""

from mgitbench import formulas
from mgitbench.devtrace import roofline_percent


def bound_s(p1, p2, *args, **kwargs):
    return formulas.bytes_bound_s(formulas.snapshot_fused_bytes(p1.numel()))


# the kernel's entry point, its device name, the least seconds of a call
PROBE = ("repro_torch.kernels.ops", "snapshot_fused_flat",
         "snapshot_fused_kernel", bound_s)


def read(run):
    return roofline_percent(run, PROBE)
