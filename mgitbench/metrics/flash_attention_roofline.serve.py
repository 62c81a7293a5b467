"""Flash attention's share of its roofline: the calls' least seconds on an
H100 (``formulas.flash_bound_s``: visible pairs, f32 as 3xTF32) over the
device seconds of the flash kernel's launches in the trace."""

from mgitbench import formulas
from mgitbench.devtrace import dtype_name, roofline_percent


def bound_s(q, k, v, *, causal=True, window=0, prefix_len=0):
    B, Hq, Sq, hd = q.shape
    return formulas.flash_bound_s(B, Hq, k.shape[1], Sq, k.shape[2], hd,
                                  dtype_name(q), causal=causal, window=window,
                                  prefix_len=prefix_len)


# the kernel's entry point, its device name, the least seconds of a call
PROBE = ("repro_torch.models.layers", "flash_attention", "flash_kernel",
         bound_s)


def read(run):
    return roofline_percent(run, PROBE)
