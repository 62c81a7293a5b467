"""The folded-chain checkout kernel's share of its byte bound (f32 base
and k int32 deltas read, f32 written, at 3.35 TB/s) over its device
seconds in the trace."""

from mgitbench import formulas
from mgitbench.devtrace import roofline_percent


def bound_s(base, qs, *args, **kwargs):
    return formulas.bytes_bound_s(formulas.chain_apply_bytes(
        base.numel(), qs.shape[0]))


# the kernel's entry point, its device name, the least seconds of a call
PROBE = ("repro_torch.kernels.ops", "chain_apply_flat", "chain_apply_kernel",
         bound_s)


def read(run):
    return roofline_percent(run, PROBE)
