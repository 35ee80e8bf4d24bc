"""The swap kernels' share of their roofline, in percent: the summed
bounds of the profiled sub-window's compacting gathers, Fletcher passes
and verified scatters (``bounds.py``, from the rows the window's
counters say they moved) over those kernels' summed device time."""
from taiji_bench import bounds

KERNELS = ("gather_pass_kernel", "fletcher_rows_kernel", "scatter_check_kernel",
           "scatter_copy_kernel")


def read(obs):
    t, p = obs.get("trace"), obs.get("profiled")
    if not t or not p:
        return None
    spent = sum(s for n, s in t["kernels"].items() if any(k in n for k in KERNELS))
    if spent <= 0:
        return None
    c, mp = p["counters"], p["mp_bytes"]
    live_in = c["mp_swapped_in"] - c["fault_zero_pages"]
    bound = (bounds.gather_nonzero_s(c["mp_swapped_out"], c["backend_compressed_mps"],
                                     c["swap_out_batches"], mp)
             + bounds.fletcher_s(c["backend_compressed_mps"], mp)
             + bounds.scatter_verified_s(c["mp_swapped_in"], live_in,
                                         c["swap_in_batches"], mp))
    return 100.0 * bound / spent
