"""The dequant kernel's share of its byte bound (p1 and int32 q read, the
result written, at 3.35 TB/s) over its device seconds in the trace; it
runs for the commit's stored value and for single-hop checkouts."""

from mgitbench import formulas
from mgitbench.devtrace import dtype_name, roofline_percent


def bound_s(p1, q, eps=None, out_dtype=None):
    out = dtype_name(p1) if out_dtype is None else str(
        out_dtype).removeprefix("torch.")
    return formulas.bytes_bound_s(formulas.dequant_apply_bytes(
        p1.numel(), dtype_name(p1), out))


# the kernel's entry point, its device name, the least seconds of a call
PROBE = ("repro_torch.kernels.ops", "dequant_apply_flat",
         "dequant_apply_kernel", bound_s)


def read(run):
    return roofline_percent(run, PROBE)
